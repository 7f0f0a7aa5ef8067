"""Where jamba J1's time goes on one NVIDIA GPU: ``chip_smoke.py``'s J1
(jamba-1.5-large-398b at its published widths, the pattern cut to positions
2-4 by ``card_config((2, 5))``, M = 4 in one process, 4,096 tokens a worker,
sparsign ``l2_norm`` 0.1 with the majority vote on allgather_packed) built
through the launcher; one step untimed, one step timed, one step traced with
torch.profiler (``chip_smoke.profile_call``: host ms, device busy share, the
port's kernels' share, the largest kernels); then one decode step of the
trained state at batch 4 traced the same way. From the repository root:

    python3 benchmarks/torch_jamba_trace.py
"""
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import jamba15_large  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.serve.decode import build_decode_step, build_prefill  # noqa: E402


def show(label: str, split: dict) -> None:
    top = ", ".join(f"{k[:60]} {v:.1%}" for k, v in split["top_kernels"].items())
    shares = ", ".join(f"{k} {v:.3%}" for k, v in split["kernel_share"].items())
    print(f"[trace] {label}: {split['call_ms']:.1f} ms, {split['kernels']} kernels, device "
          f"busy {split['busy_share']:.1%}, port kernels {split['port_kernel_share']:.3%} "
          f"({shares}); top: {top}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_jamba_trace: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    for name in build.SOURCES:
        build.library(name)
    launch.get_config = lambda arch, smoke: jamba15_large.card_config(cs.JAMBA_POSITIONS,
                                                                      smoke=smoke)
    m = cs.JAMBA_WORKERS
    args = launch.parser().parse_args([
        "--arch", cs.JAMBA_ARCH, "--host-data", str(m), "--batch", str(m), "--steps", "3",
        "--seed", "0", "--compressor", "sparsign", "--budget-kind", "l2_norm", "--budget",
        "0.1", "--server", "majority_vote", "--vote-impl", "allgather_packed", "--full",
        "--seq-len", str(cs.TRAINER_SEQ_LEN)])
    cfg, model, group, step, state, comp = launch.build_everything(args)
    batch_fn = launch.batch_fn_for(cfg, args)
    state, _ = step(state, batch_fn(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, met = step(state, batch_fn(1))
    torch.cuda.synchronize()
    print(f"[trace] {cfg.name}: untraced step {time.perf_counter() - t0:.3f} s, loss "
          f"{float(met['loss']):.6f}", flush=True)
    batch = batch_fn(2)
    show("J1 step", cs.profile_call(torch, lambda: step(state, batch)))
    params = state.params
    del step, state
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=gen, device="cuda",
                         dtype=torch.int32)
    pos = torch.arange(33, device="cuda", dtype=torch.int32).expand(4, -1)
    _, pre = build_prefill(model)(params, {"inputs": toks[:, :32], "positions": pos[:, :32]})
    caches = model.init_cache(4, 64, "cuda")
    for c, p in zip(caches, pre):
        for k, v in p.items():
            c[k][:, :v.shape[1]] = v
    decode = build_decode_step(model)
    one = {"inputs": toks[:, 32:], "positions": pos[:, 32:]}
    decode(params, caches, one)
    show("J1 decode step, batch 4", cs.profile_call(torch, lambda: decode(params, caches, one)))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
