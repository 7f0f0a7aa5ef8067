"""Where a full-width checkpoint's time goes, on one NVIDIA GPU: qwen1.5-4b's
initial state (15.8 GB once widened to float32) copied to the host, written
with np.save in one thread and in four, saved with train.checkpoint.save in
one pass and with two writer threads, restored with train.checkpoint.restore,
and the restore's pieces (np.load, the copy to the card and the narrowing;
the same from a mapped file; four loader threads). From the repository root:

    python3 benchmarks/torch_checkpoint_io.py
"""
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.compressors import tree_leaves  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.state import init_state  # noqa: E402


def timed(label: str, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    print(label, round(time.perf_counter() - t0, 3), flush=True)
    return out


def to_host(leaf):
    return leaf.to(torch.float32).cpu().numpy()


def save_pieces(d: str, state) -> None:
    leaves = tree_leaves(state.params)
    arrays = timed("d2h f32 pageable", lambda: [to_host(x) for x in leaves])

    def write(tag):
        os.makedirs(f"{d}/{tag}", exist_ok=True)
        for i, a in enumerate(arrays):
            np.save(f"{d}/{tag}/{i}.npy", a)

    timed("np.save all", lambda: write("a"))
    timed("np.save all again", lambda: write("b"))
    shutil.rmtree(f"{d}/b")

    def write_threads():
        os.makedirs(f"{d}/c", exist_ok=True)
        with ThreadPoolExecutor(4) as ex:
            list(ex.map(lambda ia: np.save(f"{d}/c/{ia[0]}.npy", ia[1]), enumerate(arrays)))

    timed("np.save 4 threads", write_threads)
    shutil.rmtree(f"{d}/c")
    del arrays
    timed("ckpt.save", lambda: ckpt.save(f"{d}/ck", 1, state))

    def save_overlapped():   # the checkpoint's leaves: parameters, step, seed
        flat = leaves + [np.int32(state.step), np.uint32(state.seed)]
        os.makedirs(f"{d}/e", exist_ok=True)
        with ThreadPoolExecutor(2) as ex:
            futures = [ex.submit(np.save, f"{d}/e/{i}.npy",
                                 to_host(x) if isinstance(x, torch.Tensor) else np.asarray(x))
                       for i, x in enumerate(flat)]
            for f in futures:
                f.result()

    timed("save overlapped (2 writers)", save_overlapped)
    shutil.rmtree(f"{d}/e")


def restore_pieces(d: str, state) -> None:
    n = len(tree_leaves(state.params))
    files = [f"{d}/ck/step_00000001/leaf_{i:05d}.npy" for i in range(n)]
    timed("ckpt.restore", lambda: ckpt.restore(f"{d}/ck", state))
    arrays = timed("np.load all", lambda: [np.load(f) for f in files])
    timed("h2d pageable + narrow",
          lambda: [torch.from_numpy(a).to("cuda").to(torch.bfloat16) for a in arrays])
    del arrays

    def load(f, **kw):
        return torch.from_numpy(np.load(f, **kw)).to("cuda").to(torch.bfloat16)

    with warnings.catch_warnings():   # a mapped array is read-only
        warnings.simplefilter("ignore")
        timed("mmap load + h2d + narrow", lambda: [load(f, mmap_mode="r") for f in files])

    def load_threads():
        with ThreadPoolExecutor(4) as ex:
            return list(ex.map(load, files))

    timed("load 4 threads + h2d + narrow", load_threads)


def main():
    for path in ("/proc/sys/vm/dirty_ratio", "/proc/sys/vm/dirty_background_ratio"):
        print(path, pathlib.Path(path).read_text().strip())
    print(subprocess.run(["findmnt", "/"], capture_output=True, text=True).stdout)
    model = Model(get_config("qwen1.5-4b"))
    state = init_state(model.init(0, "cuda"), server="majority_vote", seed=0)
    torch.cuda.synchronize()
    d = tempfile.mkdtemp()
    try:
        save_pieces(d, state)
        restore_pieces(d, state)
    finally:
        shutil.rmtree(d)


if __name__ == "__main__":
    main()
