"""mamba2-370m at full width on one NVIDIA GPU, and the premise of its
bit-for-bit restart: the port's trainer (M = 4, 4,096 tokens a worker,
sparsign with the scaled-sign EF server on allgather_packed) for three steps,
timed; the same three steps replayed from a cloned initial state and compared
bit for bit; a save and a restore of the state timed, its size on disk, the
restore compared bit for bit; one more step under
torch.use_deterministic_algorithms(True, warn_only=True), printing any op it
flags; then the serving launcher's loop, the 4 x 2048 prefill and decode
against the full forward in bf16 and float32. ``chip_smoke.py`` checks the
trainer, the restart and serving; the replay and the deterministic-mode step
are this probe's own. From the repository root:

    python3 benchmarks/torch_mamba_probe.py
"""
import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.compressors import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve.decode import build_decode_step, build_prefill  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.state import TrainState  # noqa: E402

TRAIN_ARGS = ["--arch", "mamba2-370m", "--full", "--host-data", "4", "--batch", "4",
              "--seq-len", "4096", "--seed", "0", "--compressor", "sparsign",
              "--budget-kind", "l2_norm", "--budget", "0.1", "--server", "scaled_sign_ef",
              "--vote-impl", "allgather_packed", "--steps", "4"]
SERVE_ARGS = ["--arch", "mamba2-370m", "--full", "--batch", "4", "--prompt-len", "128",
              "--tokens", "64", "--online-updates", "16", "--seed", "0"]


def clone_tree(tree):
    return None if tree is None else tree_unflatten(tree, [x.clone() for x in tree_leaves(tree)])


def clone_state(s: TrainState) -> TrainState:
    return TrainState(params=clone_tree(s.params), ef_residual=clone_tree(s.ef_residual),
                      step=s.step, seed=s.seed)


def bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def differ(a: TrainState, b: TrainState) -> list:
    """Coordinates that differ in bits, leaf by leaf (parameters, then EF)."""
    la = tree_leaves(a.params) + tree_leaves(a.ef_residual)
    lb = tree_leaves(b.params) + tree_leaves(b.ef_residual)
    return [int((bits(x) != bits(y)).sum()) for x, y in zip(la, lb)]


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def probe_trainer():
    args = launch.parser().parse_args(TRAIN_ARGS)
    torch.cuda.reset_peak_memory_stats()
    cfg, model, group, step, state, comp = launch.build_everything(args)
    print("parameters", model.param_count())
    batch_fn = launch.batch_fn_for(cfg, args)
    s0 = clone_state(state)
    for i in range(3):
        (state, m), s = timed(lambda: step(state, batch_fn(i)))
        print("step", i, s, float(m["loss"]), "peak",
              torch.cuda.max_memory_allocated() / 1e9)
    straight = clone_state(state)
    state = clone_state(s0)
    for i in range(3):
        state, _ = step(state, batch_fn(i))
    torch.cuda.synchronize()
    print("same-run replay differ:", differ(straight, state))

    d = tempfile.mkdtemp()
    try:
        _, s = timed(lambda: ckpt.save(d, 3, state))
        print("save", s)
        print(subprocess.run(["du", "-sb", d], capture_output=True, text=True).stdout)
        (restored, _), s = timed(lambda: ckpt.restore(d, state))
        print("restore", s)
        print("restore differ:", differ(restored, state), restored.step, restored.seed)
    finally:
        shutil.rmtree(d)

    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, _ = step(state, batch_fn(3))
        torch.cuda.synchronize()
    torch.use_deterministic_algorithms(False)
    print("deterministic-mode warnings:", {str(w.message)[:150] for w in caught})


def probe_serving():
    out = launch_serve.main(SERVE_ARGS)
    print({k: v for k, v in out.items() if k != "ingest_ms"}, out["ingest_ms"])
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config("mamba2-370m"), dtype=dtype)
        model = Model(cfg)
        params = model.init(0, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(5)
        toks = torch.randint(0, cfg.vocab_size, (4, 2048), generator=gen, device="cuda",
                             dtype=torch.int32)
        pos = torch.arange(2048, device="cuda", dtype=torch.int32).expand(4, -1)
        prefill = build_prefill(model)
        batch = {"inputs": toks, "positions": pos}
        prefill(params, batch)
        _, s = timed(lambda: prefill(params, batch))
        print(dtype, "prefill 4x2048", s)
        n = 128
        _, caches = prefill(params, {"inputs": toks[:, :n], "positions": pos[:, :n]})
        here = torch.full((4, 1), n, dtype=torch.int32, device="cuda")
        dec, _ = build_decode_step(model)(params, caches, {"inputs": toks[:, n:n + 1],
                                                           "positions": here})
        with torch.no_grad():
            head = model.head_weight(params)
            h = model.forward_hidden(params, {"inputs": toks[:, :n + 1],
                                              "positions": pos[:, :n + 1]})
            ref = (h[:, -1] @ head).float()
            h2 = model.forward_hidden(params, {"inputs": toks[:, :n + 2],
                                               "positions": pos[:, :n + 2]})
            longer = (h2[:, n] @ head).float()
        scale = ref.abs().max()
        print(dtype, "decode vs forward rel", float((dec.float() - ref).abs().max() / scale),
              "floor", float((longer - ref).abs().max() / scale),
              "agree", float((dec.argmax(-1) == ref.argmax(-1)).float().mean()))
        del params, caches, model
        torch.cuda.empty_cache()


def main():
    print(subprocess.run(["df", "-h", "."], capture_output=True, text=True).stdout,
          "cores", os.cpu_count())
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, s = timed(build.build_all)
    print("build", s)
    probe_trainer()
    torch.cuda.empty_cache()
    probe_serving()


if __name__ == "__main__":
    main()
