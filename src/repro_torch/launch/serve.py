"""Serving launcher of the port: ``python -m repro_torch.launch.serve --arch <id> [...]``.

A greedy batched generation loop with the KV-cache machinery, and with
``--online-updates K`` one synthetic training round's weight update every K
generated tokens over the 2-bit packed downlink (``serve.decode``). The flags
keep ``repro.launch.serve``'s names; ``--full`` serves the full-width config
and ``--device cpu`` runs the plain versions on the CPU (the default is the
card). As in the JAX launcher, the prompt is replayed through decode into a
cache as deep as prompt + generated tokens.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.models.model import Model
from repro_torch.serve.decode import build_decode_step, build_update_ingest, encode_weight_update


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false", help="full config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--online-updates", type=int, default=0, metavar="K",
                    help="apply a (synthetic) training-round weight update over the 2-bit "
                         "packed downlink wire every K generated tokens")
    return ap


def synth_round(params, r: int):
    """One synthetic training round's downlink: per leaf, integer vote sums
    in [-2, 2] from a generator seeded 1000 + r on the parameters' device,
    encoded to the 2-bit wire one leaf at a time (so no int32 copy of the
    whole tree is alive at once)."""
    leaves = tree_leaves(params)
    gen = torch.Generator(device=leaves[0].device).manual_seed(1000 + r)
    msgs = []
    for leaf in leaves:
        votes = torch.randint(-2, 3, leaf.shape, generator=gen, device=leaf.device,
                              dtype=torch.int32)
        msgs.append(encode_weight_update(votes))
        del votes
    return tree_unflatten(params, msgs)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Runs the loop; returns its numbers (tokens, seconds, decode and
    ingest times, update rounds, the last tokens)."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if not cfg.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    model = Model(cfg)
    params = model.init(args.seed, device)

    rng = np.random.RandomState(args.seed)
    b, s = args.batch, args.prompt_len
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)).to(device)
    decode = build_decode_step(model)
    ingest = build_update_ingest(model, lr=1e-4) if args.online_updates else None

    max_len = s + args.tokens
    caches = model.init_cache(b, max_len, device)
    step_s, ingest_s = [], []
    n_updates, tok = 0, None
    _sync(device)
    t0 = time.perf_counter()
    for pos in range(s + args.tokens - 1):
        inp = prompt[:, pos:pos + 1] if pos < s else tok
        batch = {"inputs": inp,
                 "positions": torch.full((b, 1), pos, dtype=torch.int32, device=device)}
        if ingest is not None and pos >= s and (pos - s) % args.online_updates == 0:
            t1 = time.perf_counter()
            params = ingest(params, synth_round(params, n_updates))
            _sync(device)
            ingest_s.append(time.perf_counter() - t1)
            n_updates += 1
        t1 = time.perf_counter()
        logits, caches = decode(params, caches, batch)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        _sync(device)
        step_s.append(time.perf_counter() - t1)
    dt = time.perf_counter() - t0
    n_generated = args.tokens * b
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU"
    print(f"generated {n_generated} tokens in {dt:.2f}s ({n_generated / dt:.1f} tok/s on "
          f"{where}, {cfg.name})")
    if n_updates:
        print(f"applied {n_updates} online weight-update rounds mid-serving (2-bit packed "
              f"downlink wire, fused vote_update apply)")
    sample = tok[:, 0].tolist()
    print("sample token ids:", sample[:8])
    return {"tokens": n_generated, "seconds": dt, "decode_steps": len(step_s),
            "decode_ms_median": statistics.median(step_s) * 1e3,
            "ingest_ms": [t * 1e3 for t in ingest_s], "updates": n_updates,
            "last_tokens": sample}


if __name__ == "__main__":
    main()
