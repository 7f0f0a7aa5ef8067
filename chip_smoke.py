#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --golomb-split [CSRC ...]   # the Golomb kernels alone
    python3 chip_smoke.py --pack2-split [CSRC ...]    # the fused 2-bit encoders alone
    python3 chip_smoke.py --pack8-split [CSRC ...]    # the qsgd8 encoder alone
    python3 chip_smoke.py --decode-split [CSRC ...]   # the 2-bit and pack8 decode-sums alone
    python3 chip_smoke.py --int8-split [CSRC ...]     # rows 1, 4 and 5 (the int8 encoders)
    python3 chip_smoke.py --sass LISTING.sass.gz      # a saved listing's loops, no card

The split forms time the Golomb wire's four kernels, the two fused 2-bit
encoders in every rule, qsgd8_pack8 in bf16 and float32, the 2-bit and
pack8 decode-sums' monolithic forms (unpack2bit_sum, unpack2bit_wsum and
unpack8_sum at M = 1 and 4), or rows 1 and 4 (also at LM_SLICE_N and the FL
shapes) and row 5 in every rule, at w_down and
split each call's device time by launch, for the kernel sources of each CSRC
directory given (default: the checkout's), A B B A for two, with each tree's
ptxas report and SASS census (listings under chiprun_out/sass/). Phases of
the first, in order; any failure exits non-zero before the last line:
  1. card, versions and TF32 flags (both set False); build the CUDA kernels
     from src/repro_torch/csrc and print the build time and ptxas report;
  2. hold each kernel against its plain PyTorch version on the card, bit for
     bit, at the main path's shapes, an odd size, 2^24 coordinates, bf16 and
     +-0/NaN/+-inf inputs (ternary: each of its four rules, per-row params;
     weighted_vote_update: scalar and per-coordinate W); time kernel, plain
     version and, where one exists, the one PyTorch call with CUDA events;
     and the timer's floor: an empty kernel and a copy of 6.54 MB; then rows
     1 and 4 on the int8 encoder (phase_int8): bit for bit at w_down in bf16
     and at tile edges, row starts off 16-byte lines, n = 1 and wrapping
     bases in f32 and bf16; noisy_sign's noise bound over all 2^24 values of
     each uniform; the fast paths' fallback counts (rows 4 and 5) on random
     gradients and on built near-ties, which must fall back; rows 1 and 4
     timed at w_down and at LM_SLICE_N beside their bounds; the SASS census
     of the encoder's loops;
  3. the federated slice: run_fl on cnn_cifar at full width (d = 545,002) in
     the Table 2 protocol (M = 20, 20% participation, batch 32) and at
     FLConfig's defaults (M = 100, full participation, batch 128), each with
     sparsignSGD (B = 1, majority vote) and EF-sparsignSGD with 5 local steps;
     then every algorithm of the §6 grid (fl/grid.py) in the Table 2 protocol
     and in the Table 1 protocol (mlp_fashion, d = 235,146, M = 50, Dir(0.1),
     batch 64); the elastic round (Table 2, weights = shard sizes, q_frac
     0.25, dropout 0.1) with signSGD and TernGrad; and the Rosenbrock
     experiment of §6.1, sign against sparsign. Launch counts are zeroed
     before each run and checked after it; each round's server half with the
     same sources equals backend="torch" bit for bit and waits for the card
     nowhere (sync debug mode);
  4. the integer-vote round: 20 workers' sparsign messages summed in int32,
     then engine.server_apply, which takes the vote_update kernel;
  5. the 2-bit packed wire's kernels (sparsign_pack2bit, ternary_pack2bit in
     each rule, unpack2bit_sum, unpack2bit_wsum) against their plain versions
     on the card, bit for bit, at w_down's 707,788,800 coordinates in bf16,
     odd sizes, +-0/NaN/+-inf gradients, M = 1, 4 and 20 messages, zero and
     fractional weights; the shared encoder's edges (sizes about a row and a
     tile, a gradient off 16-byte alignment, a counter base wrapping inside a
     thread's span, params -1/0/NaN/inf/2^24, subnormal gradients under tiny
     and huge budgets, sparsign_pack2bit == ternary_pack2bit's sparsign rule);
     the decode-sums also into int8 and int16 outputs, M = 1 accumulating
     into a nonzero output of each dtype at 8,192 rows and at w_down, and
     -0.0 products (a chain of four M = 1 decodes gives +0.0, adding into
     -0.0 keeps it); timed against their bounds (also M = 4 into int8 and
     the M = 1 hop at w_down), and the server kernels (vote_update,
     weighted_vote_update, ef_server) at w_down's shape;
  6. the Golomb/Rice wire's kernels (sparsign_golomb, golomb_pack,
     ungolomb_sum, ungolomb_wsum) against their plain versions on the card,
     bit for bit, the two encoders also against each other: w_down in bf16
     at the plan density p = 0.05, odd sizes in f32 and bf16 at counter base
     2^32 - 5000, +-0/NaN/+-inf, a message past capacity (dropped > 0), a
     lone nonzero at w_down's last coordinate, codes on each side of the
     encoder's and the decoder's tile edges and a unary run over empty
     tiles; the decode-sums at M = 1, 4 and 20 over real encoder outputs
     with a masked (all-zero) worker, M = 20's in the middle, zero and
     fractional weights, and embedding-shaped messages with saturated rows;
     timed against their bounds; then engine.compress_leaf's two-pass chain
     (sparsign, golomb_pack), counted;
  7. the ring gather (phase_ring), at w_down with M = 4 real encoder
     messages (sparsign_pack2bit, sparsign_golomb at p = 0.05, qsgd8_pack8):
     per leaf at 256 and 8,192 rows a chunk against the monolithic gather,
     pack2 and golomb bit for bit, plain and weighted (1.5, 0.5, 2, 1), pack8
     bit for bit against the plain version's sum in the ring's order (0, 3,
     2, 1) and within pack8_ring_bound of the monolithic sum (the count of
     coordinates that differ printed); one bucket of the first block's 12
     leaves against the per-leaf exchanges on each wire, monolithic and
     ringed; launches counted (chunks x M decodes; at 8,192 rows one
     exchange traced: on the 2-bit and pack8 wires nothing but the decodes
     and, weighted, W's M - 1 adds), exchanges timed on the host clock, each
     chunk's M = 1 decode and its add timed alone (the parent's hop) beside
     the fused hop that adds the decode into the accumulator in place; then
     the data-parallel LM trainer: qwen1.5-4b at full width through
     repro_torch.launch.train's build path, M = 4 workers on the card, one
     sequence of 4096 tokens each (train_4k's length; the global batch cut
     from 256 to 4), 2 steps a run (sign, noisy_sign, TernGrad and the
     elastic 2-bit and pack8 runs 1; all but the 40-layer allgather_packed
     run cut to VARIANT_LAYERS = 4 layers):
     sparsign/majority vote on the allgather_packed wire at 40 layers
     (after it its state, 15.8 GB on disk, is saved with train.checkpoint,
     restored into a fresh state and held bit for bit) and at 4 on the
     allgather_packed, psum and hier (2 x 2) wires (parameters bitwise
     equal across the three), sparsign/scaled_sign_ef, sign,
     noisy_sign and TernGrad on allgather_packed, the elastic vote (weights,
     dropout 0.25);
     sparsign_golomb with a target_sparsity budget of 0.05 on the golomb
     wire, plain and elastic, and bucketed on the ring at 8,192 rows, and
     sparsign with the same budget bucketed on the ring of the 2-bit wire
     (both bitwise equal to the golomb run's parameters, no nonzero
     dropped); qsgd8 with the mean server on the pack8 wire, on the decoded
     psum (bitwise equal), on the pack8 ring at 8,192 rows (its difference in
     ulps and its losses printed beside the pack8 run's) and on the elastic
     pack8 wire; per step loss, nnz, dropped, wire bytes (== the uplink or
     bucket-plan ledger), gathered-payload bytes (== the wire's model), host
     seconds and peak memory (a ring run's beside its monolithic twin's);
     launch counts checked with every plain version barred from running (a
     ring run's derived from its plan and chunks); one step each of the
     40-layer packed run and the 4-layer golomb run traced with
     torch.profiler; the target_sparsity bisection timed on its own (4
     layers); then the zoo at published
     widths (phase_zoo): qwen2.5-32b (GQA 40:8, QKV bias), granite-34b (MQA
     48:1) and qwen2-moe-a2.7b (60 routed experts padded to 64, top 4, 4
     shared) cut to 2 layers, gemma3-27b (5:1 windowed:global, window
     1,024, tail, tied embeddings) to 8, hubert-xlarge (frames, the GELU
     MLP, bidirectional) at its 48, M = 4, 4,096 tokens or frames a worker,
     2 steps on allgather_packed; then
     mamba2-370m at full width (M = 4, 4,096 tokens a worker, sparsign with
     the scaled-sign EF server on allgather_packed): run A 4 steps straight,
     run B checkpointing every 2 steps and dying as injected at step 3, the
     restart (the launcher in a fresh process, `chip_smoke.py
     --train-child`) whose step-4 checkpoint holds run A's parameters and
     EF residual bit for bit, and the checkpoint resumed at
     M = 2 to step 6 (step, save and restore seconds, GB on disk, wire bytes
     against the ledger, peak memory; checkpoints in a temporary directory
     removed after);
  8. the stand-alone pack and unpack kernels and the pack8 wire's kernels
     (pack2bit, unpack2bit, qsgd8_pack8, unpack8_sum) against their plain
     versions on the card, bit for bit: w_down's size, odd sizes, arbitrary
     int8 bytes, f32 and bf16 gradients with +-0/NaN/+-inf at counter base
     2^32 - 5000, M = 1, 4 and 20 with zero scales, M = 1 accumulating into a
     nonzero output at 8,192 rows and at w_down, -0.0 products as in phase
     5, and the accumulate form timed beside acc.add_(levels, alpha=s)
     (its differing values counted); qsgd8_pack8 on every bf16
     bit pattern at 350 scales and every float32 bit pattern at five, sizes
     about a row and a tile, off 16-byte alignment, a counter base wrapping
     inside a tile; timed against bounds;
  9. serving qwen1.5-4b at full width: repro_torch.launch.serve's loop (batch
     4, a 128-token prompt replayed through decode, 64 new tokens, a
     synthetic 2-bit weight-update round every 16 tokens: 4 rounds through
     pack2bit, unpack2bit and vote_update), counted with every plain version
     barred; a timed prefill of 4 x 2048 tokens; decode after a prefill
     whose cache is padded to max_len against forward_hidden's last logits,
     in bf16 and once more in float32 (15.8 GB of weights);
     one ingest round on each downlink wire (packed2bit, int8, packed8
     through qsgd8_pack8), each bitwise equal to backend="torch", the
     packed2bit route equal to server_apply on the int8 decisions; then
     mamba2-370m the same way: the launcher's loop with its 4 update rounds
     counted, a timed 4 x 2048 prefill, decode after a 128-token prefill
     against the full forward in bf16 and in float32; then the zoo served
     at full width and depth, one model at a time (phase_zoo_serve):
     qwen2.5-32b, qwen2-moe-a2.7b and gemma3-27b each through the
     launcher's loop (batch 4, a 32-token prompt, 16 new tokens, no update
     rounds), a timed 4 x 2048 prefill, and decode of token 2,048 after a
     2,048-token prefill against the full forward in bf16 (gemma3-27b's
     windowed layers from their 1,024-slot rings); hubert-xlarge's encoder
     probe on 4 x 2,048 frames, finite;
 10. the streamed (FSDP) trainer (phase_streamed), M = 4 in one process,
     4,096 tokens (frames) a worker: S1, llama4-scout-17b-a16e at its
     published widths cut to STREAMED_LAYERS[0] = 8 of 48 layers (19.7 B
     parameters), STREAMED_STEPS = 1 step of sparsign on allgather_packed per leaf through
     the launcher, launches counted (M x (8 x 13 + 3) encodes a step), wire
     bytes against the streamed ledger, its peak beside the simple
     trainer's need (weights and one worker's gradient); S2, the same cut
     to 2 layers: the streamed step per leaf (twice from one state: the
     card repeats it), bucketed (double-buffered) and the simple step, one
     step each, bit for bit, then scaled_sign_ef on psum 2 steps per leaf
     against bucketed (chunked bit digests of parameters and residual) with
     a finite residual; S3, qwen2-vl-72b (M-RoPE, frame inputs, QKV bias)
     cut to 8 of 80 layers, STREAMED_STEPS streamed steps on
     allgather_packed, then the launcher's serving loop on the same config,
     a timed 4 x 2048 prefill and decode against the full forward within
     DECODE_REL_TOL from the trained weights; under M = 4 x T = 2 ([tp
     streamed]): S1T, S1's cut through the launcher (wire bytes == the
     slice ledger, launches a message a rank), and S2T, injected gradients
     at S2's depth, one step a run: psum, the 2-bit gather, bucketed (one
     bucket, 16 MiB) and step_tp bit for bit against T = 1, Golomb under
     target_sparsity within TP_FLIP_BOUND, scaled_sign_ef within float
     noise with the same coordinates moving;
 11. jamba-1.5-large-398b (phase_jamba), J1: its published widths with the
     pattern cut to positions 2-4 (jamba15_large.card_config: mamba + dense,
     mamba + MoE, attention without RoPE + dense; 12.9 B parameters), M = 4
     in one process, 4,096 tokens a worker, one streamed step of sparsign
     (l2_norm 0.1) with the majority vote on allgather_packed through the
     launcher, launches counted, wire bytes against the streamed ledger,
     peak memory; the trained state served through the launcher's loop
     (batch 4, a 32-token prompt, 16 new tokens), a timed 4 x 2048 prefill
     and decode of token 2,048 against the full forward within
     MAMBA_DECODE_REL_TOL; J1T, the same cut's step at M = 4 x T = 2
     through the launcher; then, the state freed, sparsign_pack2bit at
     counter base 0 and at a base whose counter wraps, unpack2bit_sum of
     four messages into int8 and vote_update on a bf16 weight, all on one
     expert leaf's 3,221,225,472 coordinates, against their plain versions
     computed in 2^28-coordinate chunks, byte for byte;
 12. the analysis gate (phase_analysis), run right after the kernel checks
     of phases 2, 5, 6 and 8, before any phase traces: ``python -m
     repro_torch.analysis`` on the card (the repo-lint, every wire mode's
     recorded collective bytes against the ledger per leaf, bucketed and on
     the ring at M = 16, the launch budgets, the elastic censuses, the
     ledger floors, every fused wire op one launch, the tensor-parallel
     census at M = 4 x T = 2), its lines printed as [analysis]; nonzero
     fails;
 13. tensor parallelism (phase_tp), right after the gate: rows 1, 5, 6 and
     12 on model rank 1's slice of w_up and of lm_head at T = 2 (the
     counter map) bit for bit against their plain versions and timed
     beside as many contiguous coordinates, this run's contiguous rows
     against PERF.md's; qwen1.5-4b at full width and 40 layers, M = 4
     workers x T = 2 model ranks in one process, two steps of sparsign
     l2_norm 0.1 with majority vote on allgather_packed (launches counted,
     wire bytes == the slice ledger); at 4 layers the T = 2 round against
     T = 1 (injected gradients bit for bit on psum and allgather_packed,
     scaled_sign_ef to rtol 1e-6; the model's own gradients in float32 and
     bf16, the share of updated coordinates that differ printed; float32
     gradients no farther from float64 than TP_F64_RATIO x T = 1's); a
     checkpoint saved at T = 2 restored at T = 1 bit for bit.
It prints one JSON line of kernel numbers, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Results also go to
chiprun_out/chip_smoke.json. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import gzip
import io
import itertools
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
D_CNN = 545002
D_MLP = 235146
N_WDOWN = 40 * 6912 * 2560   # qwen1.5-4b's largest leaves (w_down, w_gate, w_up)
REPLACES = {
    "sparsign": "src/repro/kernels/sparsign/kernel.py:48",
    "vote_update": "src/repro/kernels/vote_update/kernel.py:32",
    "ef_server": "src/repro/kernels/ef_server/kernel.py:30",
    "ternary": "src/repro/kernels/ternary/kernel.py:79",
    "weighted_vote_update": "src/repro/kernels/vote_update/kernel.py:58",
    "sparsign_pack2bit": "src/repro/kernels/sparsign_pack2bit/kernel.py:61",
    "ternary_pack2bit": "src/repro/kernels/ternary/kernel.py:99",
    "unpack2bit_sum": "src/repro/kernels/pack2bit/kernel.py:91",
    "unpack2bit_wsum": "src/repro/kernels/pack2bit/kernel.py:111",
    "sparsign_golomb": "src/repro/kernels/golomb/kernel.py:58",
    "golomb_pack": "src/repro/kernels/golomb/kernel.py:88",
    "ungolomb_sum": "src/repro/kernels/golomb/kernel.py:109",
    "ungolomb_wsum": "src/repro/kernels/golomb/kernel.py:130",
    "pack2bit": "src/repro/kernels/pack2bit/kernel.py:77",
    "unpack2bit": "src/repro/kernels/pack2bit/kernel.py:133",
    "qsgd8_pack8": "src/repro/kernels/pack8/kernel.py:91",
    "unpack8_sum": "src/repro/kernels/pack8/kernel.py:111",
}
SOURCE = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
SOURCE.update({"ternary_pack2bit": "src/repro_torch/csrc/ternary.cu",
               "unpack2bit_sum": "src/repro_torch/csrc/unpack2bit.cu",
               "unpack2bit_wsum": "src/repro_torch/csrc/unpack2bit.cu",
               "sparsign_golomb": "src/repro_torch/csrc/golomb_encode.cu",
               "golomb_pack": "src/repro_torch/csrc/golomb_encode.cu",
               "ungolomb_sum": "src/repro_torch/csrc/golomb_decode.cu",
               "ungolomb_wsum": "src/repro_torch/csrc/golomb_decode.cu",
               "unpack2bit": "src/repro_torch/csrc/pack2bit.cu",
               "qsgd8_pack8": "src/repro_torch/csrc/pack8.cu",
               "unpack8_sum": "src/repro_torch/csrc/pack8.cu"})
WIRE_KERNELS = ("sparsign_pack2bit", "ternary_pack2bit", "unpack2bit_sum", "unpack2bit_wsum")
# the fused encoders, which share csrc/encode_tiles.cuh's walker
ENCODERS = WIRE_KERNELS[:2] + ("qsgd8_pack8",)
GOLOMB_KERNELS = ("sparsign_golomb", "golomb_pack", "ungolomb_sum", "ungolomb_wsum")
PACK8_KERNELS = ("pack2bit", "unpack2bit", "qsgd8_pack8", "unpack8_sum")
GOLOMB_P = 0.05              # the plan fraction of the golomb runs (target_sparsity 0.05)
# the fused 2-bit encoders' param by rule, where phase 5 and --pack2-split time them
PACK2_PARAMS = {"sparsign": 1.0, "sign": 0.0, "noisy_sign": 0.5, "stochastic_ternary": 1.5}
PACK2_TILE = 16 * 512        # coordinates of a tile of csrc/pack2_encode.cuh (kEncTileCoords)
EDGE_PARAMS = (-1.0, 0.0, float("nan"), float("inf"), 2.0**24, 0.5)
SUBNORMAL_PARAMS = (2.0**-20, 1e-30, 2.0**20, 2.0**126)
ALL_ONES_MANTISSA = 2.0 - 2.0**-23   # float32 0x3FFFFFFF: qsgd8's largest hoisted scale
TRAINER_SEQ_LEN = 4096       # train_4k's sequence, one a worker
SERVE_ARGS = ["--arch", "qwen1.5-4b", "--full", "--batch", "4", "--prompt-len", "128",
              "--tokens", "64", "--online-updates", "16", "--seed", "0"]
PREFILL_BATCH, PREFILL_LEN = 4, 2048
# decode after a prefill padded to max_len against forward_hidden's last
# logits, in bf16 at full width with random weights: max |difference| over
# max |logit|. Measured 0.0946 on "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md);
# the bound leaves a margin of 2.1x. The gap is bf16's rounding: the same
# check in float32 at full width reads 2.8e-4, and with every float32 cast of
# the norms, RoPE and attention made float64 decode equals the full forward
# (tests/test_torch_serve.py). The run also prints the noise floor of the
# dtype itself: the same logits from a forward one token longer (other GEMM
# shapes, so other cuBLAS kernels and roundings).
DECODE_REL_TOL = 0.2
# the same check in float32 at full width: a fault in the decode path (the
# cache write, the masks, the decode chunking) moves the logits by a share of
# their own size, where float32's rounding over 40 layers stays far below
# 1e-3 (4.9e-6 at smoke size on the CPU)
DECODE_F32_REL_TOL = 1e-3


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bits(t):
    import torch
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t


def same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(bits(a), bits(b)))


def max_abs_err(a, b) -> float:
    import torch
    if not a.is_floating_point() and a.element_size() == 1:   # bytes: in int16
        d = (a.to(torch.int16) - b.to(torch.int16)).abs()
        return float(d.max()) if d.numel() else 0.0
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    both_nan = torch.isnan(a.to(torch.float64)) & torch.isnan(b.to(torch.float64))
    d = torch.where(both_nan, torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


class Timer:
    """Device time of single calls with CUDA events: median and quartiles.
    Each call is queued behind a spin kernel, so the host's launch overhead
    falls inside the spin and the events time the device alone; the 50 MB L2
    is flushed before each call, so every call reads its inputs from HBM.
    ``spin=False`` drops the spin: the events then also hold whatever host
    time the enqueue takes beyond the flush, which is what a caller without a
    queue ahead of it sees."""

    SPIN_CYCLES = 2_000_000   # ~1 ms at the H100's clock: longer than any enqueue here

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.int8, device="cuda")

    def __call__(self, fn, reps: int = 30, spin: bool = True, warmup: int = 3) -> dict:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            if spin:
                torch.cuda._sleep(self.SPIN_CYCLES)
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        q1, q2, q3 = statistics.quantiles(times, n=4)
        return {"ms": q2, "p25": q1, "p75": q3}


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least ms the card could take: bytes over the memory rate against
    operations over their peak rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Operations per coordinate that each drawing rule itself needs
# (kernels/ternary/rules.py, csrc/common.cuh), one per 32-bit integer or float
# operation; loads, stores, address arithmetic and row bookkeeping are left out:
#   uniform  counter * golden, xor the row's seed hash, mix32 (3 shifts,
#            3 xors, 2 multiplies), >> 8, to float, * 2^-24          13
#   symbol   jnp_sign to int8: two compares, two selects              4
#   sparsign uniform, |g|, * B, clamp (2), u < p, select, symbol     23
#   stochastic_ternary: as sparsign with |g| / s for |g| * B         23
#   noisy_sign two uniforms, max(u1, eps), log, * -2, sqrt, 2pi * u2,
#            cos, the product, * sigma, + g, symbol                  39
# log, cos and sqrt count one operation each: the least the function needs
# (one special-function instruction); the many more that CUDA's
# full-precision versions execute are the kernel's cost, not the function's.
# The row's seed hashes count once per row: mix32(seed + golden) = 9, and for
# noisy_sign two folded seeds, each a fold (xor, mix32) and a hash, 2 x 18.
# No rate for 32-bit integer operations is published: every operation is
# taken at the float32 rate (F32_FLOPS, which counts a multiply-add as two),
# the highest scalar rate, so the bound stays a lower bound.
OPS_PER_COORD = {"sparsign": 23, "sign": 4, "noisy_sign": 39, "stochastic_ternary": 23}
OPS_PER_ROW = {"sparsign": 9, "sign": 0, "noisy_sign": 36, "stochastic_ternary": 11}
# The 2-bit wire: packing a symbol costs 3 (its code: a compare and a select;
# a shift and an or into the byte), decoding a code 6 per message (shift,
# and, two compares for the vote, the add; the weighted sum's multiply).
PACK_OPS_PER_COORD = 3
DECODE_OPS_PER_CODE = 6
# The Golomb/Rice wire, per code: encoding takes 8 (the gap: a subtract; its
# quotient: a shift; the code's end: two adds; the unary run's and the
# remainder's masks: a shift and a subtract each... counted as 4 for the bit
# writes), decoding 10 (the stop bit: a not and a find-first-set; the
# quotient: a subtract; the remainder: a shift and a mask; the gap: a shift
# and an or; the position: an add; the vote: a select; the add into the sum).
# Every coordinate the encoder reads costs its test for nonzero (1), besides
# the drawing rule's operations for the fused kernel.
GOLOMB_ENC_OPS_PER_CODE = 8
GOLOMB_DEC_OPS_PER_CODE = 10
# The pack8 wire, per coordinate: quantizing takes 27 (the uniform's 13;
# |g|, the division, floor, the fraction's subtract, u < frac, its select,
# the add, the clip; the sign's two compares and two selects; the multiply
# and the convert), and the decode 3 per worker (convert, multiply, add).
# Unpacking a 2-bit code takes 5 (a shift, a mask, two compares, a select).
QSGD8_OPS_PER_COORD = 27
UNPACK8_OPS_PER_LEVEL = 3
UNPACK_OPS_PER_CODE = 5


def rule_ops(rule: str, rows: int, n: int) -> int:
    """Operations the drawing rule needs for a (rows, n) input."""
    return rows * n * OPS_PER_COORD[rule] + rows * OPS_PER_ROW[rule]


def measure(timer, fn, plain_fn, nbytes: float, ops: float, plain_reps: int = 30,
            library=None, plain_warmup: int = 3) -> dict:
    """Kernel, no-spin and plain times (None without a plain_fn), the library
    call's where there is one, and the bound of the work."""
    t = timer(fn)
    t_b, by = bound(nbytes, ops)
    return {"ms": t["ms"], "ms_p25": t["p25"], "ms_p75": t["p75"],
            "no_spin_ms": timer(fn, spin=False)["ms"],
            "plain_ms": (timer(plain_fn, reps=plain_reps, warmup=plain_warmup)["ms"]
                         if plain_fn else None),
            "library_ms": timer(library)["ms"] if library else None,
            "bound_ms": t_b, "bound_by": by}


def print_timings(timings: dict) -> None:
    for key, t in timings.items():
        lib = f", library {t['library_ms']:.4f} ms" if t["library_ms"] is not None else ""
        plain = f"{t['plain_ms']:.4f} ms" if t["plain_ms"] is not None else "not measured"
        print(f"[timing] {key}: kernel {t['ms']:.4f} ms (quartiles {t['ms_p25']:.4f}-"
              f"{t['ms_p75']:.4f}; no spin {t['no_spin_ms']:.4f}), plain {plain}"
              f"{lib}, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{t['bound_ms'] / t['ms']:.1%} of bound")


def same_server_half(torch, label, rf, v0, r=0):
    """The round's server half with the same sources through the kernels and
    through the plain versions on the card: equal bit for bit. The kernel
    path runs in sync debug mode "error", so a host read or a host-to-device
    copy that waits for the card fails the run. Returns the sampled workers'
    ids."""
    srcs, seeds, sel = rf.workers(v0, r)
    ef = torch.zeros_like(v0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = rf.server(v0, ef, srcs, seeds, sel, r)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    b = rf.server(v0, ef, srcs, seeds, sel, r, backend="torch")
    torch.cuda.synchronize()
    check(all(same_bits(x, y) for x, y in zip(a, b)),
          f"{label}: the round's server half differs from its plain version")
    return sel


def traced(torch, report, label, rf, v0) -> None:
    """Trace one round of ``rf`` (profile_round) and report where its time went."""
    split = profile_round(torch, rf, v0)
    report.setdefault("round_profile", []).append({"setting": label, **split})
    top = ", ".join(f"{k[:60]} {v:.1%}" for k, v in split["top_kernels"].items())
    print(f"[profile] {label}: round {split['round_ms']:.2f} ms, device busy "
          f"{split['busy_share']:.1%}, port kernels {split['port_kernel_share']:.2%} "
          f"of device time; top: {top}")


def expected(**launches) -> dict:
    """Launch counts a run implies: the given kernels, and 0 for every other."""
    return {name: launches.get(name, 0) for name in REPLACES}


def profile_round(torch, rf, v) -> dict:
    """Trace one round (after a warm-up round) with torch.profiler: the
    round's host ms, the share of it during which any kernel ran (the union
    of kernel intervals), the port's kernels' share of the summed kernel time
    and the five largest kernels' shares of it."""
    ef = torch.zeros_like(v)
    rf(v, ef, 0)
    torch.cuda.synchronize()
    split = profile_call(torch, lambda: rf(v, ef, 1))
    split["round_ms"] = split.pop("call_ms")
    return split


def golomb_owner(kernel: str):
    """Which golomb source launched a CUDA kernel, by its name: the encoder's
    one pass, or the decoder's passes and its scans of transfer functions and
    of (positions, codes) pairs; None for any other kernel."""
    if "encode_tiles<" in kernel:
        return "golomb_encode"
    if "golomb::scan" in kernel or any(
            f in kernel for f in ("class_pass<", "count_pass<", "mark_pass", "emit_tiles<")):
        return "golomb_decode"
    return None


def encoder_owner(kernel: str):
    """Which fused encoder launched a CUDA kernel, by its name: all three run
    csrc/encode_tiles.cuh's encode_kernel, told apart by the encoder type
    (qsgd8_pack8's Qsgd8Encoder) and the 2-bit encoder's rule (a sparsign
    message goes through sparsign_pack2bit on every path here); None for any
    other kernel."""
    if "encode_kernel<" not in kernel:
        return None
    if "Qsgd8Encoder" in kernel:
        return "qsgd8_pack8"
    return "sparsign_pack2bit" if "SparsignRule" in kernel else "ternary_pack2bit"


def profile_call(torch, fn) -> dict:
    """Trace one call of ``fn`` (ending in a sync) with torch.profiler: its
    host ms, the share of it during which any kernel ran, the port's
    kernels' share of the summed kernel time, each port kernel's share and
    the five largest kernels' shares."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
    kern, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start:
            kern[e.name] = kern.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
            spans.append((e.time_range.start, e.time_range.end))
    total = sum(kern.values())
    check(total > 0, "the profiler saw no device time")
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    # a kernel's own name, not a longer one that ends in it (vote_update in
    # weighted_vote_update, pack2bit in sparsign_pack2bit and unpack2bit)
    per = {n: sum(t for k, t in kern.items() if re.search(rf"(?<!\w){n}_kernel\b", k))
           for n in REPLACES if n not in GOLOMB_KERNELS + ENCODERS}
    for src in ("golomb_encode", "golomb_decode"):
        per[src] = sum(t for k, t in kern.items() if golomb_owner(k) == src)
    for src in ENCODERS:
        per[src] = sum(t for k, t in kern.items() if encoder_owner(k) == src)
    ours = sum(per.values())
    top = dict(sorted(kern.items(), key=lambda kv: -kv[1])[:5])
    return {"call_ms": call_ms, "kernel_ms": total, "busy_ms": busy_us / 1e3,
            "kernels": len(spans),
            "busy_share": busy_us / 1e3 / call_ms,
            "port_kernel_ms": ours, "port_kernel_share": ours / total,
            "kernel_share": {n: t / total for n, t in per.items() if t > 0},
            "top_kernels": {k: t / total for k, t in top.items()}}


def bitwise_case(torch, errs, kind, label, kernel_fn, plain_fn):
    """``kernel_fn()`` against ``plain_fn()`` bit for bit, its error kept in
    ``errs[kind]``; returns the kernel's output."""
    k, r = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    check(same_bits(k, r), f"{kind} {label} differs from its plain version in "
                           f"{int((bits(k) != bits(r)).sum())} values")
    errs[kind] = max(errs[kind], max_abs_err(k, r))
    return k


def negative_zero_case(torch, errs, kind, kernel_fn, plain_fn, neg):
    """-0.0 products: ``neg``, four messages of negative votes or levels, at
    zero weights or scales. A ring's chain of four M = 1 decodes, the first
    writing, gives +0.0; one decode added into -0.0 keeps -0.0; each bit for
    bit its plain version's."""
    zero, shape = torch.zeros(4, device=neg.device), (neg.shape[1], 512)

    def chain(fn):
        out = torch.full(shape, float("nan"), device=neg.device)
        for i in range(4):
            fn(neg[i:i + 1], zero[i:i + 1], out=out, accumulate=i > 0)
        return out

    def into_negative_zero(fn):
        return fn(neg[:1], zero[:1], out=torch.full(shape, -0.0, device=neg.device),
                  accumulate=True)

    k = bitwise_case(torch, errs, kind, "a chain of -0.0 products", lambda: chain(kernel_fn),
                     lambda: chain(plain_fn))
    check(not bool(torch.signbit(k).any()), f"{kind}'s chain of -0.0 products gave -0.0")
    k = bitwise_case(torch, errs, kind, "-0.0 products into -0.0",
                     lambda: into_negative_zero(kernel_fn), lambda: into_negative_zero(plain_fn))
    check(bool(torch.signbit(k).all()), f"{kind} lost a -0.0 accumulator")
    print(f"[kernels] {kind} -0.0 products: a chain gives +0.0, into -0.0 keeps -0.0, bitwise ok")


# ---------------------------------------------------------------------------

def phase_kernels(torch, timer, report):
    from repro_torch.kernels.ef_server.kernel import ef_server_cuda
    from repro_torch.kernels.ef_server.ops import ef_server_op
    from repro_torch.kernels.ef_server.ref import ef_scale, ef_server_ref
    from repro_torch.kernels.sparsign.kernel import sparsign_cuda
    from repro_torch.kernels.sparsign.ops import sparsign_op
    from repro_torch.kernels.sparsign.ref import sparsign_ref
    from repro_torch.kernels.ternary.kernel import ternary_cuda
    from repro_torch.kernels.ternary.ops import ternary_compress_op
    from repro_torch.kernels.ternary.ref import ternary_compress_ref
    from repro_torch.kernels.ternary.rules import RULES
    from repro_torch.kernels.vote_update.kernel import vote_update_cuda, weighted_vote_update_cuda
    from repro_torch.kernels.vote_update.ops import vote_update_op, weighted_vote_update_op
    from repro_torch.kernels.vote_update.ref import vote_update_ref, weighted_vote_update_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def specials(n):
        x = randn(n)
        x[0:8] = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"),
                               1e-30, -1e30, -0.0], device=dev)
        return x

    errs = {name: 0.0 for name in REPLACES}

    # -- sparsign: (shape, dtype, per-row seeds?, per-row budget?, counter_base)
    cases = [((D_CNN,), torch.float32, False, False, 0),
             ((4, D_CNN), torch.float32, True, False, 0),
             ((20, D_CNN), torch.float32, True, True, 0),
             ((100, D_CNN), torch.float32, True, False, 5 * D_CNN),
             ((12345,), torch.float32, False, False, 2**32 - 5000),
             ((3, 7777), torch.bfloat16, True, True, 17),
             ((20, D_CNN), torch.bfloat16, True, False, 0),
             ((1 << 24,), torch.float32, False, False, 0),
             ((4099,), torch.float32, False, False, 0)]   # +-0 / NaN / inf
    for shape, dtype, rows, per_row_b, cb in cases:
        n = shape[-1]
        g = (specials(n) if n == 4099 else randn(*shape, scale=0.5)).to(dtype)
        seeds = (torch.randint(0, 2**32, (shape[0],), generator=gen, device=dev)
                 if rows else 0xFFFFFFFF)
        budget = (torch.rand(shape[0], generator=gen, device=dev) * 10 if per_row_b else 1.0)
        k = sparsign_op(g, budget, seeds, cb)
        r = sparsign_ref(g, budget, seeds, cb)
        torch.cuda.synchronize()
        check(same_bits(k, r), f"sparsign {shape} {dtype} differs from its plain version")
        errs["sparsign"] = max(errs["sparsign"], max_abs_err(k, r))
        print(f"[kernels] sparsign {shape} {str(dtype)[6:]} cb={cb}: bitwise ok, "
              f"nnz={float((k != 0).float().mean()):.4f}")

    # -- vote_update
    for n in (D_CNN, 12345, 1 << 24):
        for wdt in (torch.float32, torch.bfloat16):
            w = specials(n).to(wdt)
            for vdt in (torch.int8, torch.int32):
                v = torch.randint(-20, 21, (n,), generator=gen, device=dev).to(vdt)
                if vdt == torch.int32:
                    v[0] = -2**31
                for q in (1, 3):
                    k = vote_update_op(w, v, 0.03, quorum=q)
                    r = vote_update_ref(w, v, 0.03, q)
                    torch.cuda.synchronize()
                    check(same_bits(k, r), f"vote_update n={n} {wdt} {vdt} q={q} differs")
                    errs["vote_update"] = max(errs["vote_update"], max_abs_err(k, r))
        print(f"[kernels] vote_update n={n} f32/bf16 x int8/int32 x quorum 1/3: bitwise ok")

    # -- ef_server
    for n in (D_CNN, 12345, 1 << 24):
        d = specials(n) * 0.1
        e = randn(n, scale=0.01)
        e[0:4] = torch.tensor([-0.0, 0.0, -0.0, float("nan")], device=dev)
        d[8], e[8] = 0.25, -0.25
        for scale in (ef_scale(d[16:], e[16:]), torch.zeros((), device=dev)):
            k = ef_server_op(d, e, scale)
            r = ef_server_ref(d, e, scale)
            torch.cuda.synchronize()
            for a, b in zip(k, r):
                check(same_bits(a, b), f"ef_server n={n} differs from its plain version")
                errs["ef_server"] = max(errs["ef_server"], max_abs_err(a, b))
        print(f"[kernels] ef_server n={n} with +-0/NaN, two scales: bitwise ok")

    # -- ternary, each rule: (shape, dtype, per-row seeds?, per-row param?, counter_base)
    cases = [((4, D_CNN), torch.float32, True, False, 0),
             ((100, D_CNN), torch.float32, True, True, 0),
             ((50, D_MLP), torch.float32, True, True, 0),
             ((12345,), torch.float32, False, False, 2**32 - 5000),
             ((3, 7777), torch.bfloat16, True, True, 17),
             ((20, D_CNN), torch.bfloat16, True, False, 0),
             ((1 << 24,), torch.float32, False, False, 0),
             ((3, 4099), torch.float32, True, True, 0)]   # +-0 / NaN / +-inf; NaN and 0 params
    for rule in RULES:
        for shape, dtype, rows, per_row_p, cb in cases:
            n = shape[-1]
            if n == 4099:
                g = torch.stack([specials(n) for _ in range(shape[0])])
                param = torch.tensor([0.5, float("nan"), 0.0], device=dev)
            else:
                g = randn(*shape, scale=0.5)
                param = torch.rand(shape[0], generator=gen, device=dev) * 3 if per_row_p else 0.7
            g = g.to(dtype)
            seeds = (torch.randint(0, 2**32, (shape[0],), generator=gen, device=dev)
                     if rows else 0xFFFFFFFF)
            k = ternary_compress_op(g, param, seeds, cb, rule=rule)
            r = ternary_compress_ref(g, param, seeds, cb, rule=rule)
            torch.cuda.synchronize()
            check(same_bits(k, r), f"ternary {rule} {shape} {dtype} differs from its plain "
                                   f"version in {int((k != r).sum())} symbols")
            errs["ternary"] = max(errs["ternary"], max_abs_err(k, r))
        print(f"[kernels] ternary {rule}: bitwise ok at {len(cases)} shapes "
              f"(f32/bf16, odd, 2^24, +-0/NaN/+-inf, per-row params)")

    # -- weighted_vote_update: w f32/bf16 x W scalar / per coordinate / 0
    for n in (D_CNN, D_MLP, 12345, 1 << 24):
        v = (torch.randint(-8, 9, (n,), generator=gen, device=dev) * 0.5).float()
        v[0:4] = torch.tensor([-0.0, 0.0, float("nan"), 2.0], device=dev)
        for wdt in (torch.float32, torch.bfloat16):
            w = specials(n).to(wdt)
            for wtot in (torch.full((), 6.0, device=dev), torch.zeros((), device=dev),
                         torch.rand(n, generator=gen, device=dev) * 8):
                k = weighted_vote_update_op(w, v, wtot, 0.03, q_frac=0.25)
                r = weighted_vote_update_ref(w, v, wtot, 0.03, 0.25)
                torch.cuda.synchronize()
                check(same_bits(k, r), f"weighted_vote_update n={n} {wdt} W of "
                                       f"{wtot.numel()} differs from its plain version")
                errs["weighted_vote_update"] = max(errs["weighted_vote_update"],
                                                   max_abs_err(k, r))
        print(f"[kernels] weighted_vote_update n={n} f32/bf16 x W scalar/0/per-coord: bitwise ok")

    # -- timing at the main path's shapes: the launch wrappers themselves
    timings = {}

    def record(key, fn, plain_fn, nbytes, ops, plain_reps=30, library=None):
        timings[key] = measure(timer, fn, plain_fn, nbytes, ops, plain_reps, library)

    # sparsign and ternary: operations are the rule's own (rule_ops)
    for rows in (1, 4, 20, 100):
        g = randn(rows, D_CNN, scale=0.01)
        seeds = torch.arange(rows, device=dev) * 7919
        b = torch.ones(1, device=dev)
        record(f"sparsign {rows}x{D_CNN} f32", lambda: sparsign_cuda(g, b, seeds),
               lambda: sparsign_ref(g, b, seeds), rows * D_CNN * 5 + rows * 8 + 4,
               rule_ops("sparsign", rows, D_CNN), plain_reps=10)
    for rule in RULES:
        for rows, n in ((4, D_CNN), (100, D_CNN), (50, D_MLP)):
            g = randn(rows, n, scale=0.01)
            seeds = torch.arange(rows, device=dev) * 7919
            prm = torch.rand(rows, generator=gen, device=dev) * 0.05 + 0.005
            # the PyTorch yardstick of the sign rule: torch.sign maps -0.0 to
            # +0.0 and NaN to 0 where jnp.sign keeps them; the int8 cast
            # makes the symbols the rule's
            lib = (lambda: torch.sign(g).to(torch.int8)) if rule == "sign" else None
            record(f"ternary {rule} {rows}x{n} f32",
                   lambda: ternary_cuda(g, prm, seeds, rule=rule),
                   lambda: ternary_compress_ref(g, prm, seeds, rule=rule),
                   rows * n * 5 + rows * 12,
                   rule_ops(rule, rows, n), plain_reps=10, library=lib)
    w = randn(D_CNN)
    v = torch.randint(-20, 21, (D_CNN,), generator=gen, device=dev, dtype=torch.int32)
    record(f"vote_update {D_CNN} f32/int32", lambda: vote_update_cuda(w, v, 0.03),
           lambda: vote_update_ref(w, v, 0.03), D_CNN * 12, D_CNN * 2)
    d, e = randn(D_CNN, scale=0.1), randn(D_CNN, scale=0.01)
    s = ef_scale(d, e).reshape(1)
    record(f"ef_server {D_CNN} f32", lambda: ef_server_cuda(d, e, s),
           lambda: ef_server_ref(d, e, s), D_CNN * 16 + 4, D_CNN * 3)
    for n in (D_CNN, D_MLP):
        v = (torch.randint(-8, 9, (n,), generator=gen, device=dev) * 0.5).float()
        for wdt in (torch.float32, torch.bfloat16):
            w = randn(n).to(wdt)
            for wtot in (torch.full((1,), 6.0, device=dev), torch.rand(n, generator=gen, device=dev) * 8):
                per = "per-coord" if wtot.numel() == n else "scalar"
                record(f"weighted_vote_update {n} {str(wdt)[6:]} W {per}",
                       lambda: weighted_vote_update_cuda(w, v, wtot, 0.03, 0.25),
                       lambda: weighted_vote_update_ref(w, v, wtot, 0.03, 0.25),
                       n * (2 * w.element_size() + 4) + wtot.numel() * 4, n * 3)
    print_timings(timings)
    report["timings"] = timings
    # the timer's floor: an empty kernel, and a copy that moves vote_update's
    # bytes at the FL shape (6.54 MB: half read, half written), as Timer sees them
    src = randn(D_CNN * 3 // 2)
    dst = torch.empty_like(src)
    floor = {"empty_kernel_ms": timer(lambda: torch.cuda._sleep(0))["ms"],
             "copy_ms": timer(lambda: dst.copy_(src))["ms"],
             "copy_bytes": D_CNN * 12, "copy_bound_ms": bound(D_CNN * 12, 0)[0]}
    print(f"[timing] timer floor: empty kernel {floor['empty_kernel_ms']:.4f} ms; a copy "
          f"moving {D_CNN * 12 / 1e6:.2f} MB (vote_update's at the FL shape) "
          f"{floor['copy_ms']:.4f} ms, bound {floor['copy_bound_ms']:.4f} ms")
    report["timer_floor"] = floor
    main_shape = {"sparsign": f"sparsign 100x{D_CNN} f32",
                  "vote_update": f"vote_update {D_CNN} f32/int32",
                  "ef_server": f"ef_server {D_CNN} f32",
                  "ternary": f"ternary stochastic_ternary 50x{D_MLP} f32",
                  "weighted_vote_update": f"weighted_vote_update {D_CNN} float32 W scalar"}
    return errs, {k: timings[v] for k, v in main_shape.items()}


#: the int8 encoder's edge cases (rows, n, counter_base, element offset of g):
#: rows about a run (16), a tile (4,096 and 8,192) and an FL row long, row
#: starts anywhere on a 16-byte line, g off 16-byte alignment, bases that wrap
INT8_EDGES = [(1, 1, 0, 0), (7, 1, 3, 0), (1000, 5, 2**32 - 9, 0), (33, 17, 0, 1),
              (3, 4095, 2**32 - 7, 0), (2, 4096, 0, 0), (5, 4097, 17, 1), (9, 8191, 0, 0),
              (4, 8192, 2**32 - 5000, 0), (3, 8193, 5, 3), (3, D_CNN, 2**32 - 300000, 0),
              (2, D_CNN, 0, 1)]
INT8_NEAR_TIES = 1 << 20     # coordinates of the built near-tie inputs


def noise_bound(torch) -> dict:
    """noisy_sign's fast path bound, over every uniform the kernels draw:
    Â, A, Ĉ and C at all 2^24 values (``noise_table``, the library's own
    code); the compiled delta must cover max|Â - A| max|Ĉ| + max|A| max|Ĉ -
    C| + 2^-22 (n's own rounding, |A C| < 8)."""
    from repro_torch.kernels.ternary.kernel import noise_table

    tab, delta = noise_table("cuda")
    check(bool(torch.isfinite(tab).all()), "the noise table holds a value that is not finite")
    t = tab.double()
    out = {"err_radius": float((t[0] - t[1]).abs().max()),
           "err_angle": float((t[2] - t[3]).abs().max()),
           "max_radius": float(t[1].abs().max()), "max_angle_approx": float(t[2].abs().max()),
           "delta": float(delta)}
    del tab, t
    out["needed"] = (out["err_radius"] * out["max_angle_approx"] +
                     out["max_radius"] * out["err_angle"] + 2.0**-22) * (1 + 2.0**-40)
    print(f"[int8] noise bound over 2^24 uniforms each: max|Â - A| {out['err_radius']:.4e}, "
          f"max|Ĉ - C| {out['err_angle']:.4e}, max|A| {out['max_radius']:.7f}, max|Ĉ| "
          f"{out['max_angle_approx']:.7f}: needs {out['needed']:.4e}, delta {out['delta']:.4e}")
    check(out["needed"] <= out["delta"], f"noisy_sign's compiled delta {out['delta']} does not "
                                         f"cover the measured bound {out['needed']}")
    return out


def near_ties(torch, seed: int, m: int) -> dict:
    """Inputs that sit in the fast paths' bands, each rule's (g, param):
    stochastic_ternary's |g| / s at its own uniform (a few ulps either way),
    noisy_sign's g at -sigma n of its own noise (on it, and a few ulps off)."""
    from repro_torch.core import prng

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.arange(m, device=dev)
    s = torch.tensor(seed, device=dev)
    wiggle = 1 + torch.randint(-3, 4, (m,), generator=gen, device=dev).float() * 2.0**-23
    sign = torch.where(torch.rand(m, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    u1 = torch.clamp(prng.uniform01(prng.fold_seed(s, 1), idx), min=1e-12)
    u2 = prng.uniform01(prng.fold_seed(s, 2), idx)
    noise = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        torch.tensor(2.0 * math.pi, device=dev, dtype=torch.float32) * u2)
    return {"stochastic_ternary": (prng.uniform01(s, idx) * 0.37 * wiggle * sign, 0.37),
            "noisy_sign": (-(0.3 * noise) * wiggle, 0.3)}


def phase_int8(torch, timer, report):
    """Rows 1 and 4 on the int8 encoder (csrc/int8_encode.cuh) and the
    rules' fast paths, which row 5 shares: bit for bit against the plain
    versions at w_down in bf16 (every rule) and at INT8_EDGES in float32 and
    bf16; noisy_sign's noise bound over every uniform (noise_bound); the
    fallbacks of rows 4 and 5 on the phase's random gradients and on built
    near-ties (which must fall back, and stay bit for bit); rows 1 and 4 at
    w_down and at LM_SLICE_N contiguous coordinates timed beside their
    bounds (the sign rule beside ``torch.sign(g).to(int8)``); the SASS
    census of the encoder's loops."""
    from repro_torch.kernels import build
    from repro_torch.kernels.sparsign.kernel import sparsign_cuda
    from repro_torch.kernels.sparsign.ops import sparsign_op
    from repro_torch.kernels.sparsign.ref import sparsign_ref
    from repro_torch.kernels.ternary.kernel import ternary_cuda, ternary_fallbacks
    from repro_torch.kernels.ternary.ops import ternary_compress_op, ternary_pack2bit_op
    from repro_torch.kernels.ternary.ref import ternary_compress_ref, ternary_pack2bit_ref
    from repro_torch.kernels.ternary.rules import RULES

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(27)
    errs = {"sparsign": 0.0, "ternary": 0.0}
    out = report["int8"] = {}

    def held(kind, label, k, r):
        torch.cuda.synchronize()
        check(same_bits(k, r), f"{kind} {label} differs from its plain version in "
                               f"{int((k != r).sum())} symbols")
        errs[kind] = max(errs[kind], max_abs_err(k, r))

    # -- edges: tiles, row starts, alignment, tiny rows, wrapping bases
    for dtype in (torch.float32, torch.bfloat16):
        for rows, n, base, off in INT8_EDGES:
            g = torch.randn(rows * n + off, generator=gen, device=dev) * 0.5
            g[off:off + 8] = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e-30,
                                           -3e-39, 0.0, -0.0, 2.0**-130], device=dev)[:rows * n]
            g = g.to(dtype)[off:].reshape(rows, n)
            seeds = torch.randint(0, 2**32, (rows,), generator=gen, device=dev)
            prm = torch.rand(rows, generator=gen, device=dev) * 3
            prm[:3] = torch.tensor([float("nan"), 0.0, float("inf")], device=dev)[:rows]
            for p in (prm, torch.tensor([0.7], device=dev)):
                held("sparsign", f"{rows}x{n} {dtype} base {base} offset {off}",
                     sparsign_op(g, p, seeds, base), sparsign_ref(g, p, seeds, base))
                for rule in RULES:
                    held("ternary", f"{rule} {rows}x{n} {dtype} base {base} offset {off}",
                         ternary_compress_op(g, p, seeds, base, rule=rule),
                         ternary_compress_ref(g, p, seeds, base, rule=rule))
    print(f"[int8] rows 1 and 4 (every rule) at {len(INT8_EDGES)} edge shapes in f32 and bf16, "
          f"per-row and shared params: bitwise ok")

    # -- w_down in bf16: bit for bit, the fallbacks, and the times
    n = N_WDOWN
    g = (torch.randn(n, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    seed = torch.full((1,), 12345, dtype=torch.int64, device=dev)
    chunk = 1 << 26

    def plain_rows(ref, x, p, **kw):
        return torch.cat([ref(x[s:s + chunk], p, 12345, s, **kw)
                          for s in range(0, x.numel(), chunk)])

    held("sparsign", "w_down bf16", sparsign_op(g, 1.0, 12345), plain_rows(sparsign_ref, g, 1.0))
    fallbacks = out["fallbacks"] = {}
    ternary_fallbacks(dev)
    for rule in RULES:
        p = PACK2_PARAMS[rule]
        k = ternary_compress_op(g, p, 12345, rule=rule)
        fallbacks[f"ternary {rule} w_down"] = ternary_fallbacks(dev)
        held("ternary", f"{rule} w_down bf16", k, plain_rows(ternary_compress_ref, g, p, rule=rule))
        del k
        ternary_pack2bit_op(g, p, 12345, rule=rule)
        fallbacks[f"ternary_pack2bit {rule} w_down"] = ternary_fallbacks(dev)
    for key, count in fallbacks.items():
        print(f"[int8] fallbacks {key}: {count} of {n} coordinates ({count / n:.3e})")
    timings = {}
    for label, x in (("w_down", g), ("lm_head slice", g[:LM_SLICE_N])):
        m = x.numel()
        prm = {rule: torch.full((1,), PACK2_PARAMS[rule], device=dev) for rule in RULES}
        timings[f"sparsign {label} bf16"] = measure(
            timer, lambda x=x: sparsign_cuda(x, prm["sparsign"], seed),
            lambda x=x: plain_rows(sparsign_ref, x, prm["sparsign"][0]), m * 3 + 12,
            rule_ops("sparsign", 1, m), plain_reps=3)
        for rule in RULES:
            # the sign rule's PyTorch yardstick, as phase_kernels times it
            lib = (lambda x=x: torch.sign(x).to(torch.int8)) if rule == "sign" else None
            timings[f"ternary {rule} {label} bf16"] = measure(
                timer, lambda x=x, rule=rule: ternary_cuda(x, prm[rule], seed, rule=rule),
                lambda x=x, rule=rule: plain_rows(ternary_compress_ref, x, prm[rule][0],
                                                  rule=rule),
                m * 3 + 12, rule_ops(rule, 1, m), plain_reps=3, library=lib)
    del g
    print_timings(timings)
    report["int8_timings"] = timings

    # -- the fast paths: the noise bound, and near-ties that must fall back
    out["noise_bound"] = noise_bound(torch)
    ties = near_ties(torch, 4242, INT8_NEAR_TIES)
    for rule, (x, p) in ties.items():
        ternary_fallbacks(dev)
        held("ternary", f"{rule} near ties", ternary_compress_op(x, p, 4242, rule=rule),
             ternary_compress_ref(x, p, 4242, rule=rule))
        row4 = ternary_fallbacks(dev)
        k = ternary_pack2bit_op(x, p, 4242, rule=rule)
        check(same_bits(k, ternary_pack2bit_ref(x, p, 4242, rule=rule)),
              f"ternary_pack2bit {rule} near ties differs from its plain version")
        row5 = ternary_fallbacks(dev)
        fallbacks[f"{rule} near ties (rows 4, 5)"] = [row4, row5]
        print(f"[int8] {rule} near ties: rows 4 and 5 bitwise ok; fallbacks {row4} and {row5} "
              f"of {INT8_NEAR_TIES}")
        check(row4 > 0 and row5 > 0, f"{rule}'s near ties never fell back")
    del ties

    # -- the SASS census of the encoder's loops (bf16, no counter map)
    census = out["sass"] = {}
    for name in ("sparsign", "ternary"):
        c = sass_census(build._lib_path(name),
                        ROOT / "chiprun_out" / "sass" / f"smoke-{name}.sass.gz")
        for fn, body in c.items():
            if "encode_rows_kernel" in fn and "nv_bfloat16" in fn and "ELi0EEEv" in fn:
                census[fn] = [(lp["instructions"], lp["straight"], lp["hot"])
                              for lp in body["loops"]]
    for fn, loops in census.items():
        print(f"[int8] SASS {fn[:110]}: loops (instructions, straight path, hot path) "
              f"{loops[:4]}")
    return errs, {}


def phase_fl(torch, report):
    from repro_torch import kernels
    from repro_torch.core.algorithm import CompressionConfig
    from repro_torch.core.budgets import BudgetConfig
    from repro_torch.data.dirichlet import dirichlet_partition
    from repro_torch.data.synthetic import ImageDataConfig, make_image_dataset
    from repro_torch.fl.models import cnn_cifar, xent_loss
    from repro_torch.fl.simulation import FLConfig, build_round_fn, run_fl, stack_partitions

    rounds, tau = 3, 5
    algos = {
        "sparsignSGD_B1": (CompressionConfig(budget=BudgetConfig(value=1.0),
                                             server="majority_vote"), 0.01),
        "ef_sparsignSGD_local5": (CompressionConfig(budget=BudgetConfig(value=1.0),
                                                    server="scaled_sign_ef", local_steps=tau,
                                                    local_budget=10.0), 0.02),
    }
    x, y, xt, yt = make_image_dataset(ImageDataConfig(
        n_classes=10, shape=(32, 32, 3), n_train=2000, n_test=500, noise=1.0, seed=1))
    v0, apply_fn = cnn_cifar(torch.Generator().manual_seed(1), device="cuda")
    check(v0.numel() == D_CNN, f"cnn_cifar has {v0.numel()} parameters, not {D_CNN}")
    settings = {
        "table2": lambda comp, llr: FLConfig(n_workers=20, rounds=rounds, participation=0.2,
                                             batch_size=32, lr=0.03, local_lr=llr, comp=comp,
                                             seed=1, eval_every=rounds),
        "defaults": lambda comp, llr: FLConfig(rounds=rounds, local_lr=llr, comp=comp,
                                               seed=1, eval_every=rounds),
    }
    totals = {k: 0 for k in kernels.launch_counts()}
    parts_of = {}
    for sname, make_cfg in settings.items():
        for aname, (comp, llr) in algos.items():
            cfg = make_cfg(comp, llr)
            if cfg.n_workers not in parts_of:
                parts = dirichlet_partition(y, n_workers=cfg.n_workers, alpha=0.5, seed=1)
                parts_of[cfg.n_workers] = stack_partitions(x, y, parts)
            xp, yp = parts_of[cfg.n_workers]
            kernels.reset_launch_counts()
            res = run_fl(v0, apply_fn, cfg, xp, yp, xt, yt)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            n_sel = max(1, round(cfg.participation * cfg.n_workers))
            steps = comp.local_steps + 1 if comp.local_steps > 1 else 1
            want = expected(sparsign=rounds * steps,
                            ef_server=rounds if comp.server == "scaled_sign_ef" else 0)
            check(counts == want, f"{sname}/{aname}: launches {counts}, expected {want}")
            check(bool(torch.isfinite(res["v"]).all()), f"{sname}/{aname}: non-finite weights")
            check(0.0 <= res["final_acc"] <= 1.0 and 0 < res["mean_nnz"] <= D_CNN,
                  f"{sname}/{aname}: accuracy or nnz out of range")
            for k in totals:
                totals[k] += counts[k]
            line = {"setting": sname, "algorithm": aname, "workers": n_sel,
                    "round_s": res["round_s"], "final_acc": res["final_acc"],
                    "mean_nnz": res["mean_nnz"], "d": res["d"], "launches": counts}
            report.setdefault("fl", []).append(line)
            print(f"[fl] {json.dumps(line)}")

    # where a round's device time goes: one traced round per cell, after the
    # counted runs (its launches are not counted)
    for sname, make_cfg in settings.items():
        for aname, (comp, llr) in algos.items():
            cfg = make_cfg(comp, llr)
            rf = build_round_fn(xent_loss(apply_fn), cfg, *parts_of[cfg.n_workers])
            traced(torch, report, f"{sname}/{aname}", rf, v0)

    # the server half with injected sources: kernels == plain versions on the card
    # (after the counted runs: comparison launches are not counted)
    xp, yp = parts_of[20]
    for aname, (comp, llr) in algos.items():
        rf = build_round_fn(xent_loss(apply_fn), settings["table2"](comp, llr), xp, yp)
        same_server_half(torch, aname, rf, v0)
        print(f"[fl] {aname}: server half with injected sources == backend='torch', bitwise")

    # phase 4: the integer-vote round (the psum wire in one process)
    from repro_torch.core import engine
    comp = algos["sparsignSGD_B1"][0]
    cfg = FLConfig(n_workers=20, participation=1.0, batch_size=32, lr=0.03, comp=comp, seed=1)
    rf = build_round_fn(xent_loss(apply_fn), cfg, xp, yp)
    srcs, seeds, _ = rf.workers(v0, 0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    msgs = engine.compress_leaf(srcs, comp, seeds)
    vote_sum = msgs.values.sum(0, dtype=torch.int32)
    v1, _ = engine.server_apply(v0, vote_sum, comp, lr=cfg.lr)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(counts == expected(sparsign=1, vote_update=1),
          f"integer-vote round launches {counts}")
    for k in totals:
        totals[k] += counts[k]
    msgs_t = engine.compress_leaf(srcs, comp, seeds, backend="torch")
    v1_t, _ = engine.server_apply(v0, msgs_t.values.sum(0, dtype=torch.int32), comp,
                                  lr=cfg.lr, backend="torch")
    torch.cuda.synchronize()
    check(same_bits(msgs.values, msgs_t.values) and same_bits(v1, v1_t),
          "integer-vote round differs from its plain version")
    moved = float((v1 != v0).float().mean())
    check(0.0 < moved <= 1.0 and bool(torch.isfinite(v1).all()), "integer-vote round no-op")
    print(f"[vote] 20 workers x {D_CNN}: int32 votes |max|={int(vote_sum.abs().max())}, "
          f"moved {moved:.4f} of coordinates, launches {counts}, == plain version bitwise")
    report["integer_vote_round"] = {"launches": counts, "moved": moved}
    return totals


def phase_baselines(torch, report, totals):
    """The §6 grid in the Table 1 and Table 2 protocols, the elastic round and
    the Rosenbrock experiment, each run counted on its own."""
    from repro_torch import kernels
    from repro_torch.data.dirichlet import dirichlet_partition
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.fl import grid, models, rosenbrock
    from repro_torch.fl.simulation import build_round_fn, run_fl, stack_partitions

    rounds = 3

    def counted(label, fn, want):
        """Run ``fn`` with every count zeroed just before and read just after."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check(counts == want, f"{label}: launches {counts}, expected {want}")
        for k in totals:
            totals[k] += counts[k]
        return out, counts

    def launches_of(comp, elastic=False):
        if comp.compressor == "sparsign":
            return expected(sparsign=rounds,
                            ef_server=rounds if comp.server == "scaled_sign_ef" else 0)
        return expected(ternary=rounds, weighted_vote_update=rounds if elastic
                        and comp.server == "majority_vote" else 0)

    protocols = {
        # Table 2's training set cut from 6,000 to 2,000 images for time, as above
        "table2": (dataclasses.replace(grid.TABLE2, data=dataclasses.replace(
            grid.TABLE2.data, n_train=2000)), models.cnn_cifar, D_CNN),
        "table1": (grid.TABLE1, models.mlp_fashion, D_MLP),
    }
    setups = {}
    for pname, (proto, make_model, d) in protocols.items():
        x, y, xt, yt = make_image_dataset(proto.data)
        parts = dirichlet_partition(y, n_workers=proto.n_workers, alpha=proto.alpha,
                                    seed=proto.partition_seed)
        xp, yp = stack_partitions(x, y, parts)
        v0, apply_fn = make_model(torch.Generator().manual_seed(proto.model_seed), device="cuda")
        check(v0.numel() == d, f"{proto.model} has {v0.numel()} parameters, not {d}")
        setups[pname] = (proto, parts, xp, yp, xt, yt, v0, apply_fn)
        for aname, comp in grid.ALGORITHMS.items():
            cfg = proto.fl_config(comp, rounds=rounds, eval_every=rounds)
            res, counts = counted(f"{pname}/{aname}",
                                  lambda: run_fl(v0, apply_fn, cfg, xp, yp, xt, yt),
                                  launches_of(comp))
            check(bool(torch.isfinite(res["v"]).all()) and res["v"].shape == v0.shape,
                  f"{pname}/{aname}: non-finite weights")
            check(0.0 <= res["final_acc"] <= 1.0 and 0 < res["mean_nnz"] <= d,
                  f"{pname}/{aname}: accuracy or nnz out of range")
            line = {"setting": pname, "algorithm": aname, "workers": round(
                        cfg.participation * cfg.n_workers), "round_s": res["round_s"],
                    "final_acc": res["final_acc"], "mean_nnz": res["mean_nnz"],
                    "d": res["d"], "launches": counts}
            report.setdefault("fl", []).append(line)
            print(f"[fl] {json.dumps(line)}")
            rf = build_round_fn(models.xent_loss(apply_fn), cfg, xp, yp)
            same_server_half(torch, f"{pname}/{aname}", rf, v0)
        print(f"[fl] {pname}: every algorithm's server half == backend='torch', bitwise, "
              f"with no host sync")

    # the elastic round: Table 2 with data-volume weights and report dropout
    proto, parts, xp, yp, xt, yt, v0, apply_fn = setups["table2"]
    elastic = dict(worker_weights=tuple(float(len(p)) for p in parts), q_frac=0.25, dropout=0.1)
    for aname in ("signSGD", "terngrad"):
        comp = grid.ALGORITHMS[aname]
        cfg = proto.fl_config(comp, rounds=rounds, eval_every=rounds, **elastic)
        res, counts = counted(f"elastic/{aname}",
                              lambda: run_fl(v0, apply_fn, cfg, xp, yp, xt, yt),
                              launches_of(comp, elastic=True))
        check(bool(torch.isfinite(res["v"]).all()) and 0.0 <= res["final_acc"] <= 1.0,
              f"elastic/{aname}: non-finite weights or accuracy out of range")
        line = {"setting": "elastic", "algorithm": aname,
                "workers": round(cfg.participation * cfg.n_workers),
                "round_s": res["round_s"], "final_acc": res["final_acc"],
                "mean_nnz": res["mean_nnz"], "d": res["d"], "launches": counts}
        report.setdefault("fl", []).append(line)
        print(f"[fl] {json.dumps(line)}")
        rf = build_round_fn(models.xent_loss(apply_fn), cfg, xp, yp)
        dropped = 0
        for r in range(rounds):
            sel = same_server_half(torch, f"elastic/{aname} round {r}", rf, v0, r)
            dropped += int((~rf.reporting(sel, r)[0]).sum())
        print(f"[fl] elastic/{aname}: server half == backend='torch' bitwise, with no host "
              f"sync, in {rounds} rounds ({dropped} reports dropped)")

    # where a round's device time goes in the new cells (after the counted runs)
    proto, parts, xp, yp, xt, yt, v0, apply_fn = setups["table1"]
    traced(torch, report, "table1/signSGD", build_round_fn(
        models.xent_loss(apply_fn), proto.fl_config(grid.ALGORITHMS["signSGD"]), xp, yp), v0)
    proto, parts, xp, yp, xt, yt, v0, apply_fn = setups["table2"]
    for aname in ("signSGD", "terngrad"):
        traced(torch, report, f"elastic/{aname}", build_round_fn(
            models.xent_loss(apply_fn), proto.fl_config(grid.ALGORITHMS[aname], **elastic),
            xp, yp), v0)

    # §6.1 Rosenbrock (Fig. 1): sign against sparsign, 100 workers, every one voting
    ros = {}
    for name, kernel in (("sign", "ternary"), ("sparsign", "sparsign")):
        ros[name], _ = counted(
            f"rosenbrock/{name}",
            lambda: rosenbrock.run(name, budget=0.01, rounds=120, n_sel=100, lr=1e-3),
            expected(**{kernel: 120}))
    r_sign, r_sp = ros["sign"], ros["sparsign"]
    check(r_sign.wrong_agg.mean() > 0.9 and r_sp.wrong_agg.mean() < 0.5
          and r_sp.values[-1] < r_sp.values[0] and r_sp.values[-1] < r_sign.values[-1],
          "Rosenbrock: the paper's Fig. 1 claims do not hold")
    report["rosenbrock"] = {n: {"wrong_agg_mean": float(r.wrong_agg.mean()),
                                "F_first": float(r.values[0]), "F_last": float(r.values[-1])}
                            for n, r in ros.items()}
    print(f"[rosenbrock] {json.dumps(report['rosenbrock'])}")


def chunked_plain(ref, g, param, seed, counter_base=0, chunk=1 << 24, **kw):
    """A fused pack op's plain version over a large input in chunks of whole
    row blocks (2^24 coordinates = 32,768 canonical rows, a multiple of the
    32-row pad) with the counter running on: the bytes of one call, with the
    int64 hash temporaries of one chunk."""
    import torch
    flat = g.reshape(-1)
    return torch.cat([ref(flat[s:s + chunk], param, seed, (counter_base + s) & 0xFFFFFFFF, **kw)
                      for s in range(0, flat.numel(), chunk)])


def phase_wire_kernels(torch, timer, report):
    """The 2-bit packed wire's four kernels against their plain versions on
    the card, bit for bit, and their times against their bounds."""
    from repro_torch.kernels.common import canonical_rows
    from repro_torch.kernels.ef_server.kernel import ef_server_cuda
    from repro_torch.kernels.ef_server.ref import ef_scale, ef_server_ref
    from repro_torch.kernels.pack2bit.kernel import unpack2bit_sum_cuda, unpack2bit_wsum_cuda
    from repro_torch.kernels.pack2bit.ref import unpack2bit_sum_ref, unpack2bit_wsum_ref
    from repro_torch.kernels.sparsign_pack2bit.kernel import sparsign_pack2bit_cuda
    from repro_torch.kernels.sparsign_pack2bit.ops import sparsign_pack2bit_op
    from repro_torch.kernels.sparsign_pack2bit.ref import sparsign_pack2bit_ref
    from repro_torch.kernels.ternary.kernel import ternary_pack2bit_cuda
    from repro_torch.kernels.ternary.ops import ternary_pack2bit_op
    from repro_torch.kernels.ternary.ref import ternary_pack2bit_ref
    from repro_torch.kernels.ternary.rules import RULES
    from repro_torch.kernels.vote_update.kernel import vote_update_cuda, weighted_vote_update_cuda
    from repro_torch.kernels.vote_update.ref import vote_update_ref, weighted_vote_update_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    errs = {name: 0.0 for name in WIRE_KERNELS}
    params = PACK2_PARAMS

    def grads(n, dtype):
        g = torch.randn(n, generator=gen, device=dev) * 0.5
        if n == 4099:   # +-0 / NaN / +-inf / tiny / huge, and a zero in 97
            g[0:8] = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"),
                                   1e-30, -1e30, -0.0], device=dev)
            g[::97] = 0.0
        return g.to(dtype)

    # -- the fused packs: (n, dtype, counter_base); w_down's size is the path's.
    # sparsign runs through its own kernel and as the ternary kernel's rule
    cases = [(N_WDOWN, torch.bfloat16, 0), (12345, torch.float32, 2**32 - 5000),
             (12345, torch.bfloat16, 17), (4099, torch.float32, 0), (1 << 24, torch.float32, 0)]
    for n, dtype, cb in cases:
        g = grads(n, dtype)
        seed = int(torch.randint(0, 2**32, (1,), generator=gen, device=dev))
        checks = [("sparsign_pack2bit", "sparsign")] + [("ternary_pack2bit", r) for r in RULES]
        for kind, rule in checks:
            p = params[rule]
            if kind == "sparsign_pack2bit":
                k = sparsign_pack2bit_op(g, p, seed, cb)
                r = chunked_plain(sparsign_pack2bit_ref, g, p, seed, cb)
            else:
                k = ternary_pack2bit_op(g, p, seed, cb, rule=rule)
                r = chunked_plain(ternary_pack2bit_ref, g, p, seed, cb, rule=rule)
            torch.cuda.synchronize()
            check(k.shape == (canonical_rows(n), 128) and same_bits(k, r),
                  f"{kind} {rule} n={n} {dtype} differs from its plain version in "
                  f"{int((k != r).sum())} bytes")
            errs[kind] = max(errs[kind], max_abs_err(k, r))
            del k, r
        print(f"[wire] sparsign_pack2bit and ternary_pack2bit (every rule) n={n} "
              f"{str(dtype)[6:]} cb={cb}: bitwise ok")
        del g

    # -- the shared encoder's edges (csrc/pack2_encode.cuh): sizes about a row
    # and a tile, a gradient one element off 16-byte alignment (no vector
    # path), a counter base that wraps inside a thread's span, every rule's
    # param at -1, 0, NaN, inf and 2^24, subnormal gradients under tiny and
    # huge budgets; sparsign_pack2bit equal to ternary_pack2bit's sparsign rule
    t = PACK2_TILE
    edge = [(1, torch.bfloat16, 0, 0, None), (511, torch.bfloat16, 3, 0, None),
            (512, torch.float32, 0, 0, None), (513, torch.bfloat16, 0, 0, None),
            (t - 1, torch.bfloat16, 2**32 - 7, 0, None), (t, torch.bfloat16, 2**32 - 7, 0, None),
            (t + 1, torch.float32, 2**32 - 7, 0, EDGE_PARAMS),
            (t + 1, torch.bfloat16, 11, 0, EDGE_PARAMS),
            (2 * t + 513, torch.bfloat16, 2**32 - 7, 1, None), (t + 1, torch.float32, 5, 1, None),
            (3 * t, torch.bfloat16, 0, 0, SUBNORMAL_PARAMS),
            (3 * t + 7, torch.float32, 2**32 - 7, 0, SUBNORMAL_PARAMS)]
    for n, dtype, cb, off, sweep in edge:
        g = grads(n + off, dtype)[off:]
        if sweep is SUBNORMAL_PARAMS:   # |g| about 2^-130: subnormal in f32 and bf16
            g = (grads(n, torch.float32) * 2.0**-130).to(dtype)
        elif n > 8:
            g[:8] = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"),
                                  1e-30, -1e30, -0.0], device=dev).to(dtype)
        seed = int(torch.randint(0, 2**32, (1,), generator=gen, device=dev))
        for rule in RULES:
            for p in sweep or (params[rule],):
                k = ternary_pack2bit_op(g, p, seed, cb, rule=rule)
                r = ternary_pack2bit_ref(g, p, seed, cb, rule=rule)
                torch.cuda.synchronize()
                check(k.shape == (canonical_rows(n), 128) and same_bits(k, r),
                      f"ternary_pack2bit {rule} n={n} {dtype} offset {off} cb={cb} param={p} "
                      f"differs from its plain version in {int((k != r).sum())} bytes")
                if rule == "sparsign":
                    ks = sparsign_pack2bit_op(g, p, seed, cb)
                    torch.cuda.synchronize()
                    check(same_bits(ks, k), f"sparsign_pack2bit n={n} {dtype} offset {off} "
                                            f"cb={cb} B={p} differs from ternary_pack2bit's "
                                            f"sparsign rule in {int((ks != k).sum())} bytes")
                errs["ternary_pack2bit"] = max(errs["ternary_pack2bit"], max_abs_err(k, r))
        print(f"[wire] encoder edge n={n} {str(dtype)[6:]} offset {off} cb={cb} params "
              f"{'sweep' if sweep else 'default'}: every rule bitwise ok, sparsign_pack2bit "
              f"== ternary_pack2bit(sparsign)")

    # -- the decode-sums: M messages of random bytes (code 3 included), into a
    # new int32 sum and into an int8 and an int16 output
    for m, rows in ((1, canonical_rows(N_WDOWN)), (4, canonical_rows(N_WDOWN)),
                    (20, canonical_rows(N_WDOWN)), (3, canonical_rows(12345))):
        p = torch.randint(0, 256, (m, rows, 128), generator=gen, device=dev, dtype=torch.uint8)
        w = torch.rand(m, generator=gen, device=dev) * 2
        w[::2] = torch.tensor([0.0, 1.0, 0.3, 1.7, 0.5] * 4, device=dev)[:w[::2].numel()]
        for dt in (torch.int32, torch.int16, torch.int8):
            def out():
                return torch.empty((rows, 512), dtype=dt, device=dev)
            bitwise_case(torch, errs, "unpack2bit_sum", f"M={m} rows={rows} {dt}",
                         lambda: unpack2bit_sum_cuda(p, out=None if dt == torch.int32 else out()),
                         lambda: unpack2bit_sum_ref(p, out=out()))
        for wt in (w, torch.zeros(m, device=dev)):
            bitwise_case(torch, errs, "unpack2bit_wsum", f"M={m} rows={rows}",
                         lambda: unpack2bit_wsum_cuda(p, wt), lambda: unpack2bit_wsum_ref(p, wt))
        print(f"[wire] unpack2bit_sum (int32, int16, int8) and unpack2bit_wsum (zero and "
              f"fractional weights) M={m} rows={rows}: bitwise ok")
        del p

    # -- the ring's hop: M = 1 added into a nonzero accumulator (each output
    # dtype; floats with +-0.0 among them), at 8,192 rows and at w_down
    for rows in (RING_ROWS[1], canonical_rows(N_WDOWN)):
        p = torch.randint(0, 256, (1, rows, 128), generator=gen, device=dev, dtype=torch.uint8)
        for dt in (torch.int8, torch.int16, torch.int32):
            a0 = torch.randint(-100, 101, (rows, 512), generator=gen, device=dev).to(dt)
            bitwise_case(torch, errs, "unpack2bit_sum", f"M=1 rows={rows} {dt} accumulating",
                         lambda: unpack2bit_sum_cuda(p, out=a0.clone(), accumulate=True),
                         lambda: unpack2bit_sum_ref(p, out=a0.clone(), accumulate=True))
            del a0
        a0 = torch.randn(rows * 512, generator=gen, device=dev)
        a0[::7], a0[1::7] = -0.0, 0.0
        for wt in (torch.full((1,), 0.3, device=dev), torch.zeros(1, device=dev)):
            bitwise_case(torch, errs, "unpack2bit_wsum",
                         f"M=1 rows={rows} weight {float(wt):g} accumulating",
                         lambda: unpack2bit_wsum_cuda(p, wt, out=a0.clone(), accumulate=True),
                         lambda: unpack2bit_wsum_ref(p, wt, out=a0.clone(), accumulate=True))
        print(f"[wire] unpack2bit_sum (int8, int16, int32) and unpack2bit_wsum M=1 rows={rows} "
              f"accumulating into a nonzero output: bitwise ok")
        del p, a0

    # -- -0.0 products: zero weights on -1 votes
    negative_zero_case(torch, errs, "unpack2bit_wsum", unpack2bit_wsum_cuda, unpack2bit_wsum_ref,
                       torch.full((4, RING_ROWS[1], 128), 0xAA, dtype=torch.uint8, device=dev))

    # -- timing at the path's shapes: w_down in bf16, M = 4 (and 1, 20)
    timings = {}
    n, rows = N_WDOWN, canonical_rows(N_WDOWN)
    g = grads(n, torch.bfloat16)
    seed = torch.full((1,), 12345, dtype=torch.int64, device=dev)
    for rule in ("sparsign",) + tuple(RULES):
        prm = torch.full((1,), params[rule], device=dev)
        seed0, prm0 = seed[0], prm[0]   # the plain versions take one stream as a 0-d seed
        nbytes = n * 2 + rows * 128 + 12
        ops = n * (OPS_PER_COORD[rule] + PACK_OPS_PER_COORD) + OPS_PER_ROW[rule]
        if rule == "sparsign":
            timings[f"sparsign_pack2bit w_down bf16"] = measure(
                timer, lambda: sparsign_pack2bit_cuda(g, prm, seed),
                lambda: chunked_plain(sparsign_pack2bit_ref, g, prm0, seed0), nbytes, ops,
                plain_reps=3)
        timings[f"ternary_pack2bit {rule} w_down bf16"] = measure(
            timer, lambda: ternary_pack2bit_cuda(g, prm, seed, rule=rule),
            lambda: chunked_plain(ternary_pack2bit_ref, g, prm0, seed0, rule=rule), nbytes, ops,
            plain_reps=3)
    del g
    for m in (1, 4, 20):
        p = torch.randint(0, 256, (m, rows, 128), generator=gen, device=dev, dtype=torch.uint8)
        w = torch.rand(m, generator=gen, device=dev) * 2
        nbytes = m * rows * 128 + rows * 512 * 4
        ops = m * rows * 512 * DECODE_OPS_PER_CODE
        timings[f"unpack2bit_sum M={m} w_down"] = measure(
            timer, lambda: unpack2bit_sum_cuda(p), lambda: unpack2bit_sum_ref(p), nbytes, ops,
            plain_reps=3)
        timings[f"unpack2bit_wsum M={m} w_down"] = measure(
            timer, lambda: unpack2bit_wsum_cuda(p, w), lambda: unpack2bit_wsum_ref(p, w),
            nbytes + m * 4, ops, plain_reps=3)
        if m == 4:   # the monolithic wire's output: _sum_dtype(4), int8
            o8 = torch.empty((rows, 512), dtype=torch.int8, device=dev)
            timings["unpack2bit_sum M=4 w_down int8"] = measure(
                timer, lambda: unpack2bit_sum_cuda(p, out=o8),
                lambda: unpack2bit_sum_ref(p, out=o8), m * rows * 128 + rows * 512, ops,
                plain_reps=3)
        if m == 1:   # the ring's hop at w_down: add into the accumulator
            a8 = torch.zeros((rows, 512), dtype=torch.int8, device=dev)
            af = torch.zeros((rows, 512), device=dev)
            timings["unpack2bit_sum M=1 w_down int8 accumulating"] = measure(
                timer, lambda: unpack2bit_sum_cuda(p, out=a8, accumulate=True),
                lambda: unpack2bit_sum_ref(p, out=a8, accumulate=True),
                rows * 128 + 2 * rows * 512, ops, plain_reps=3)
            timings["unpack2bit_wsum M=1 w_down accumulating"] = measure(
                timer, lambda: unpack2bit_wsum_cuda(p, w, out=af, accumulate=True),
                lambda: unpack2bit_wsum_ref(p, w, out=af, accumulate=True),
                rows * 128 + 2 * rows * 512 * 4 + 4, ops, plain_reps=3)
            del a8, af
        del p
    # the server kernels at the trainer's shape: each leaf of w_down's size,
    # f32 parameters, int8 vote sums (f32 weighted sums, scalar W)
    w = torch.randn(n, generator=gen, device=dev)
    v = torch.randint(-4, 5, (n,), generator=gen, device=dev, dtype=torch.int8)
    timings["vote_update w_down f32/int8"] = measure(
        timer, lambda: vote_update_cuda(w, v, 0.03), lambda: vote_update_ref(w, v, 0.03),
        n * 9, n * 2, plain_reps=3)
    wv, wtot = v.float() * 0.5, torch.full((1,), 6.0, device=dev)
    del v
    timings["weighted_vote_update w_down f32 W scalar"] = measure(
        timer, lambda: weighted_vote_update_cuda(w, wv, wtot, 0.03, 0.25),
        lambda: weighted_vote_update_ref(w, wv, wtot, 0.03, 0.25), n * 12 + 4, n * 3,
        plain_reps=3)
    e = torch.randn(n, generator=gen, device=dev) * 0.01
    sc = ef_scale(wv, e).reshape(1)
    timings["ef_server w_down f32"] = measure(
        timer, lambda: ef_server_cuda(wv, e, sc), lambda: ef_server_ref(wv, e, sc),
        n * 16 + 4, n * 3, plain_reps=3)
    del w, wv, e
    print_timings(timings)
    report["wire_timings"] = timings
    main_shape = {"sparsign_pack2bit": "sparsign_pack2bit w_down bf16",
                  "ternary_pack2bit": "ternary_pack2bit sign w_down bf16",
                  "unpack2bit_sum": "unpack2bit_sum M=4 w_down",
                  "unpack2bit_wsum": "unpack2bit_wsum M=4 w_down"}
    return errs, {k: timings[v] for k, v in main_shape.items()}


def golomb_header(coded) -> tuple:
    """(shipped, dropped) from a coded message's header."""
    import torch
    return tuple(int(x) for x in coded.reshape(-1)[:8].view(torch.int32).tolist())


def phase_golomb_kernels(torch, timer, report):
    """The Golomb/Rice wire's four kernels against their plain versions on
    the card, bit for bit (the two encoders also against each other), and
    their times against their bounds."""
    from repro_torch.core.budgets import solve_budget_for_sparsity
    from repro_torch.kernels.golomb import ref as gref
    from repro_torch.kernels.golomb.kernel import (golomb_pack_cuda, sparsign_golomb_cuda,
                                                   ungolomb_sum_cuda, ungolomb_wsum_cuda)
    from repro_torch.kernels.sparsign.ref import sparsign_ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"
    p = GOLOMB_P
    b = gref.rice_b(p)
    errs = {name: 0.0 for name in GOLOMB_KERNELS}
    stats = torch.zeros(1, dtype=torch.int64, device=dev)
    mismatched = []   # segments whose decoded exit is not the next composed entry

    def encode_case(label, g, budget, seed, cb=0):
        """Both encoders against the plain sparsign -> encode; returns the
        plain ternary message and its coded bytes."""
        n = g.numel()
        rows = gref.golomb_rows(n, p)
        bud = budget.reshape(1).to(torch.float32)
        sd = torch.full((1,), seed, dtype=torch.int64, device=dev)
        t = chunked_plain(sparsign_ref, g, bud[0], sd[0], cb)
        want = gref.golomb_encode_ref(t, p=p)
        fused = sparsign_golomb_cuda(g, bud, sd, cb, b=b, rows=rows)
        two_pass = golomb_pack_cuda(t, b=b, rows=rows)
        torch.cuda.synchronize()
        for name, got in (("sparsign_golomb", fused), ("golomb_pack", two_pass)):
            check(same_bits(got, want), f"{name} {label} differs from its plain version in "
                                        f"{int((got != want).sum())} bytes")
            errs[name] = max(errs[name], max_abs_err(got, want))
        shipped, dropped = golomb_header(want)
        print(f"[golomb] sparsign_golomb and golomb_pack {label} (n={n}, {str(g.dtype)[6:]}, "
              f"cb={cb}): bitwise ok, fused == two-pass; shipped {shipped} dropped {dropped} "
              f"of capacity {rows} rows")
        del fused, two_pass
        return t, want

    def decode_case(label, gathered, n, weight_sets):
        k = ungolomb_sum_cuda(gathered, n, b=b, stats=stats)
        r = gref.ungolomb_sum_ref(gathered, n, (n,), p=p)
        torch.cuda.synchronize()
        check(same_bits(k, r), f"ungolomb_sum {label} differs from its plain version")
        errs["ungolomb_sum"] = max(errs["ungolomb_sum"], max_abs_err(k, r))
        mismatched.append({"case": label, "segments": int(stats[0])})
        check(int(stats[0]) == 0, f"ungolomb_sum {label}: {int(stats[0])} segments' exits are "
                                  f"not their successors' entries")
        del k, r
        for w in weight_sets:
            k = ungolomb_wsum_cuda(gathered, w, n, b=b)
            r = gref.ungolomb_wsum_ref(gathered, w, n, (n,), p=p)
            torch.cuda.synchronize()
            check(same_bits(k, r), f"ungolomb_wsum {label} differs from its plain version in "
                                   f"{int((bits(k) != bits(r)).sum())} values")
            errs["ungolomb_wsum"] = max(errs["ungolomb_wsum"], max_abs_err(k, r))
            del k, r
        print(f"[golomb] ungolomb_sum and ungolomb_wsum {label}: bitwise ok, every segment's "
              f"exit its successor's entry")

    def weights(m):
        w = torch.rand(m, generator=gen, device=dev) * 2
        w[1 % m] = 0.0
        return [w, torch.zeros(m, device=dev)]

    # -- the encoders. w_down in bf16 at the plan density (the target_sparsity
    # budget), odd sizes in f32 and bf16 near the top of the counter, +-0 /
    # NaN / +-inf, a message past capacity, and a lone nonzero at w_down's
    # last coordinate (a 44M-bit unary run)
    g = (torch.randn(N_WDOWN, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    bud = solve_budget_for_sparsity(g, p)
    t0, coded0 = encode_case("w_down", g, bud, 1)
    for n, dtype, cb in ((12345, torch.float32, 2**32 - 5000), (12345, torch.bfloat16, 2**32 - 5000),
                         (4099, torch.float32, 0)):
        x = torch.randn(n, generator=gen, device=dev) * 0.5
        if n == 4099:
            x[0:8] = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"),
                                   1e-30, -1e30, -0.0], device=dev)
            x[::97] = 0.0
        encode_case(f"odd {n}", x.to(dtype), torch.full((), p / 0.4, device=dev), 7, cb)
    _, over = encode_case("overflow 12345", torch.randn(12345, generator=gen, device=dev),
                          torch.full((), 3.0, device=dev), 9)
    check(golomb_header(over)[1] > 0, "the overflow case dropped nothing")
    lone = torch.zeros(N_WDOWN, dtype=torch.bfloat16, device=dev)
    lone[-1] = -5.0
    _, lone_coded = encode_case("lone nonzero at w_down's end", lone,
                                torch.ones((), device=dev), 3)
    check(golomb_header(lone_coded) == (1, 0), "the lone nonzero is not one shipped code")
    del lone
    # the designs at their edges (the w_down message above is 43,200 encoder
    # tiles, far more than the card holds at once, so its look-back crosses
    # waves): codes on each side of output-tile (2,048) and encoder-tile
    # (16,384) edges, and a unary run that crosses five empty encoder tiles
    # and many output-tile edges; the budget makes sparsign(g) = sign(g)
    n_e = 1 << 20
    at = [2047, 2048, 16383, 16384, 16385 + 5 * 16384 + 2100, n_e - 1]
    edges = torch.zeros(n_e, device=dev)
    edges[at] = torch.tensor([1.0, -1.0, -1.0, 1.0, -1.0, 1.0], device=dev)
    t_e, coded_e = encode_case("tile edges and a run over empty tiles", edges,
                               torch.full((), 1e30, device=dev), 5)
    check(golomb_header(coded_e) == (len(at), 0), "the tile-edge message lost a code")
    decode_case("tile edges, M=1", coded_e[None], n_e, weights(1))
    check(same_bits(ungolomb_sum_cuda(coded_e[None], n_e, b=b), t_e.to(torch.int32)),
          "ungolomb_sum of the tile-edge message differs from its votes")
    del edges, t_e, coded_e

    # -- the decode-sums over real encoder outputs: M = 1 and 4 at w_down (the
    # third of four an all-zero, masked worker), M = 20 at one layer's w_down
    # (17,694,720 coordinates; the eleventh, in the middle, masked); zero and
    # fractional weights
    rows = gref.golomb_rows(N_WDOWN, p)
    sd = [torch.full((1,), s, dtype=torch.int64, device=dev) for s in range(20)]
    coded = [coded0] + [sparsign_golomb_cuda(g, bud.reshape(1), sd[s], b=b, rows=rows)
                        for s in (11, 12, 13)]
    coded[2] = torch.zeros_like(coded0)
    decode_case("M=1 w_down", coded0[None], N_WDOWN, weights(1))
    gath4 = torch.stack(coded)
    decode_case("M=4 w_down", gath4, N_WDOWN, weights(4))
    lone_t = torch.zeros(N_WDOWN, dtype=torch.int32, device=dev)
    lone_t[-1] = -1
    k = ungolomb_sum_cuda(lone_coded[None], N_WDOWN, b=b)
    torch.cuda.synchronize()
    check(same_bits(k, lone_t), "ungolomb_sum of the lone nonzero differs")
    del k, lone_t
    # a structured message: the embedding leaf's shape (151,936 x 2,560) with
    # the rows of 16,384 random tokens active, as a 4 x 4,096-token batch
    # touches them; the budget saturates those rows (density near 0.5), a
    # low-entropy stretch where speculative parses stay misaligned and the
    # decoder has to find anchors
    emb = torch.zeros(151936, 2560, dtype=torch.bfloat16, device=dev)
    active = torch.randint(0, 151936, (16384,), generator=gen, device=dev)
    emb[active] = (torch.randn(16384, 2560, generator=gen, device=dev) * 1e-3).to(torch.bfloat16)
    emb = emb.reshape(-1)
    bud_e = solve_budget_for_sparsity(emb, p)
    encode_case("embedding-shaped, active rows saturated", emb, bud_e, 21)
    rows_e = gref.golomb_rows(emb.numel(), p)
    gath_e = torch.stack([sparsign_golomb_cuda(emb, bud_e.reshape(1), sd[s], b=b, rows=rows_e)
                          for s in (3, 4, 5, 6)])
    del emb
    decode_case("M=4 embedding-shaped", gath_e, 151936 * 2560, weights(4))
    n20 = 6912 * 2560
    g20 = g[:n20]
    bud20 = solve_budget_for_sparsity(g20, p).reshape(1)
    rows20 = gref.golomb_rows(n20, p)
    gath20 = torch.stack([sparsign_golomb_cuda(g20, bud20, sd[s], b=b, rows=rows20)
                          for s in range(20)])
    gath20[10] = 0
    decode_case("M=20 one layer's w_down", gath20, n20, weights(20))
    del gath20
    report["golomb_mismatched_segments"] = mismatched

    # -- timing at the path's shapes: w_down in bf16, M = 4 (and 1, 20)
    timings = {}
    nnz = golomb_header(coded0)[0]
    sd0, bud1 = sd[1], bud.reshape(1)
    timings["sparsign_golomb w_down bf16"] = measure(
        timer, lambda: sparsign_golomb_cuda(g, bud1, sd0, b=b, rows=rows),
        lambda: gref.golomb_encode_ref(chunked_plain(sparsign_ref, g, bud1[0], sd0[0]), p=p),
        N_WDOWN * 2 + rows * 128 + 12,
        rule_ops("sparsign", 1, N_WDOWN) + N_WDOWN + nnz * GOLOMB_ENC_OPS_PER_CODE,
        plain_reps=2, plain_warmup=1)
    del g
    timings["golomb_pack w_down int8"] = measure(
        timer, lambda: golomb_pack_cuda(t0, b=b, rows=rows),
        lambda: gref.golomb_encode_ref(t0, p=p), N_WDOWN + rows * 128,
        N_WDOWN + nnz * GOLOMB_ENC_OPS_PER_CODE, plain_reps=2, plain_warmup=1)
    del t0
    gath1 = coded0[None]
    gath20 = torch.stack([coded0] * 20)
    for m, gath in ((1, gath1), (4, gath4), (20, gath20)):
        shipped = sum(golomb_header(c)[0] for c in gath)
        w = torch.rand(m, generator=gen, device=dev) * 2
        nbytes = m * rows * 128 + N_WDOWN * 4
        ops = shipped * GOLOMB_DEC_OPS_PER_CODE
        plain = m <= 4   # the plain decode takes about a second a message
        timings[f"ungolomb_sum M={m} w_down"] = measure(
            timer, lambda: ungolomb_sum_cuda(gath, N_WDOWN, b=b),
            (lambda: gref.ungolomb_sum_ref(gath, N_WDOWN, (N_WDOWN,), p=p)) if plain else None,
            nbytes, ops, plain_reps=2, plain_warmup=1)
        timings[f"ungolomb_wsum M={m} w_down"] = measure(
            timer, lambda: ungolomb_wsum_cuda(gath, w, N_WDOWN, b=b),
            (lambda: gref.ungolomb_wsum_ref(gath, w, N_WDOWN, (N_WDOWN,), p=p)) if plain else None,
            nbytes + m * 4, ops, plain_reps=2, plain_warmup=1)
    n_emb = 151936 * 2560
    shipped = sum(golomb_header(c)[0] for c in gath_e)
    timings["ungolomb_sum M=4 embedding-shaped"] = measure(
        timer, lambda: ungolomb_sum_cuda(gath_e, n_emb, b=b), None,
        4 * rows_e * 128 + n_emb * 4, shipped * GOLOMB_DEC_OPS_PER_CODE)
    del gath1, gath4, gath20, gath_e, coded, coded0
    print_timings(timings)
    report["golomb_timings"] = timings
    main_shape = {"sparsign_golomb": "sparsign_golomb w_down bf16",
                  "golomb_pack": "golomb_pack w_down int8",
                  "ungolomb_sum": "ungolomb_sum M=4 w_down",
                  "ungolomb_wsum": "ungolomb_wsum M=4 w_down"}
    return errs, {k: timings[v] for k, v in main_shape.items()}


def phase_pack8_kernels(torch, timer, report):
    """The stand-alone pack and unpack kernels (the serving downlink) and the
    pack8 wire's kernels against their plain versions on the card, bit for
    bit, and their times against their bounds."""
    from repro_torch.core.compressors import qsgd8_scale
    from repro_torch.kernels.common import canonical_rows, to_2d
    from repro_torch.kernels.pack2bit.kernel import pack2bit_cuda, unpack2bit_cuda
    from repro_torch.kernels.pack2bit.ref import pack2bit_ref, unpack2bit_ref
    from repro_torch.kernels.pack8.kernel import qsgd8_pack8_cuda, unpack8_sum_cuda
    from repro_torch.kernels.pack8.ops import qsgd8_pack8_op
    from repro_torch.kernels.pack8.ref import qsgd8_pack8_ref, unpack8_sum_ref

    gen = torch.Generator(device="cuda").manual_seed(8)
    dev = "cuda"
    errs = {name: 0.0 for name in PACK8_KERNELS}

    def int8s(n, lo=-1, hi=2):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=torch.int8)

    # -- pack2bit and unpack2bit: w_down's size (the downlink's largest leaf),
    # odd sizes, and arbitrary int8 bytes (which pack as the plain version's
    # uint8 shifts do)
    for n, lo, hi in ((N_WDOWN, -1, 2), (12345, -1, 2), (4099, -128, 128), (1, -1, 2)):
        t = int8s(n, lo, hi)
        k, r = pack2bit_cuda(t), pack2bit_ref(to_2d(t)[0])
        torch.cuda.synchronize()
        check(k.shape == (canonical_rows(n), 128) and same_bits(k, r),
              f"pack2bit n={n} differs from its plain version in {int((k != r).sum())} bytes")
        errs["pack2bit"] = max(errs["pack2bit"], max_abs_err(k, r))
        del r
        uk, ur = unpack2bit_cuda(k), unpack2bit_ref(k)
        torch.cuda.synchronize()
        check(same_bits(uk, ur), f"unpack2bit n={n} differs from its plain version")
        if hi == 2:
            check(torch.equal(uk.reshape(-1)[:n], t), f"pack2bit -> unpack2bit n={n} is not "
                                                      f"the identity on ternary input")
        errs["unpack2bit"] = max(errs["unpack2bit"], max_abs_err(uk, ur))
        del k, uk, ur, t
    print("[pack8] pack2bit and unpack2bit n=707788800, 12345, 4099 (any byte), 1: bitwise ok")

    # -- qsgd8_pack8: the trainer's scale and a small one (levels up to the
    # clip), f32 and bf16, +-0/NaN/+-inf, the counter past 2^32
    cases = [(N_WDOWN, torch.bfloat16, 0), (12345, torch.float32, 2**32 - 5000),
             (12345, torch.bfloat16, 17), (4099, torch.float32, 0), (1 << 24, torch.float32, 0)]
    for n, dtype, cb in cases:
        g = torch.randn(n, generator=gen, device=dev) * 0.5
        if n == 4099:
            g[0:8] = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"),
                                   1e-30, -1e30, -0.0], device=dev)
        g = g.to(dtype)
        seed = int(torch.randint(0, 2**32, (1,), generator=gen, device=dev))
        for scale in (qsgd8_scale(g), torch.full((), 0.01, device=dev)):
            k = qsgd8_pack8_op(g, scale, seed, cb)
            r = chunked_plain(qsgd8_pack8_ref, g, scale, seed, cb).reshape(-1, 512)
            torch.cuda.synchronize()
            check(k.shape == (canonical_rows(n), 512) and same_bits(k, r),
                  f"qsgd8_pack8 n={n} {dtype} scale={float(scale):.3g} differs from its plain "
                  f"version in {int((k != r).sum())} bytes")
            errs["qsgd8_pack8"] = max(errs["qsgd8_pack8"], max_abs_err(k, r))
            del k, r
        print(f"[pack8] qsgd8_pack8 n={n} {str(dtype)[6:]} cb={cb} (its own scale and 0.01): "
              f"bitwise ok")
        del g

    qsgd8_exhaustive(torch, gen, errs)

    # -- unpack8_sum: M messages of random levels; worker 0's scale is 0, so
    # its negative levels give -0.0 products, which the +0.0 seed absorbs
    for m, rows in ((1, canonical_rows(N_WDOWN)), (4, canonical_rows(N_WDOWN)),
                    (20, canonical_rows(N_WDOWN)), (3, canonical_rows(12345))):
        lv = torch.randint(-127, 128, (m, rows, 512), generator=gen, device=dev,
                           dtype=torch.int8)
        sc = torch.rand(m, generator=gen, device=dev) * 0.01
        sc[0] = 0.0
        k, r = unpack8_sum_cuda(lv, sc), unpack8_sum_ref(lv, sc)
        torch.cuda.synchronize()
        check(same_bits(k, r), f"unpack8_sum M={m} rows={rows} differs from its plain version "
                               f"in {int((bits(k) != bits(r)).sum())} values")
        if m == 1:
            check(not bool(torch.signbit(k).any()), "unpack8_sum M=1 at scale 0 gave -0.0")
        errs["unpack8_sum"] = max(errs["unpack8_sum"], max_abs_err(k, r))
        del k, r, lv
        print(f"[pack8] unpack8_sum M={m} rows={rows} (a zero scale): bitwise ok")

    # -- the ring's hop: M = 1 added into a nonzero accumulator (+-0.0 among
    # it), zero and fractional scales, at 8,192 rows and at w_down
    for rows in (RING_ROWS[1], canonical_rows(N_WDOWN)):
        lv = torch.randint(-127, 128, (1, rows, 512), generator=gen, device=dev,
                           dtype=torch.int8)
        a0 = torch.randn(rows * 512, generator=gen, device=dev)
        a0[::7], a0[1::7] = -0.0, 0.0
        for s1 in (torch.full((1,), 3e-3, device=dev), torch.zeros(1, device=dev)):
            bitwise_case(torch, errs, "unpack8_sum", f"M=1 rows={rows} scale {float(s1):g} "
                         f"accumulating",
                         lambda: unpack8_sum_cuda(lv, s1, out=a0.clone(), accumulate=True),
                         lambda: unpack8_sum_ref(lv, s1, out=a0.clone(), accumulate=True))
        print(f"[pack8] unpack8_sum M=1 rows={rows} accumulating into a nonzero output: "
              f"bitwise ok")
        del lv, a0

    # -- -0.0 products: a zero scale on negative levels
    negative_zero_case(torch, errs, "unpack8_sum", unpack8_sum_cuda, unpack8_sum_ref,
                       torch.full((4, RING_ROWS[1], 512), -5, dtype=torch.int8, device=dev))

    # -- timing at the path's shapes: w_down, the trainer's bf16 gradient,
    # M = 4 (and 1, 20)
    timings = {}
    n, rows = N_WDOWN, canonical_rows(N_WDOWN)
    t = int8s(n)
    timings["pack2bit w_down"] = measure(
        timer, lambda: pack2bit_cuda(t), lambda: pack2bit_ref(to_2d(t)[0]),
        n + rows * 128, n * PACK_OPS_PER_COORD, plain_reps=3)
    packed = pack2bit_cuda(t)
    del t
    timings["unpack2bit w_down"] = measure(
        timer, lambda: unpack2bit_cuda(packed), lambda: unpack2bit_ref(packed),
        rows * 128 + rows * 512, n * UNPACK_OPS_PER_CODE, plain_reps=3)
    del packed
    g = (torch.randn(n, generator=gen, device=dev) * 1e-3).to(torch.bfloat16)
    scale = qsgd8_scale(g).reshape(1)
    seed = torch.full((1,), 12345, dtype=torch.int64, device=dev)
    timings["qsgd8_pack8 w_down bf16"] = measure(
        timer, lambda: qsgd8_pack8_cuda(g, scale, seed),
        lambda: chunked_plain(qsgd8_pack8_ref, g, scale[0], seed[0]),
        n * 2 + rows * 512 + 12, n * QSGD8_OPS_PER_COORD, plain_reps=3)
    del g
    for m in (1, 4, 20):
        lv = torch.randint(-127, 128, (m, rows, 512), generator=gen, device=dev,
                           dtype=torch.int8)
        sc = torch.rand(m, generator=gen, device=dev) * 0.01
        timings[f"unpack8_sum M={m} w_down"] = measure(
            timer, lambda: unpack8_sum_cuda(lv, sc), lambda: unpack8_sum_ref(lv, sc),
            m * rows * 512 + rows * 512 * 4 + m * 4, m * rows * 512 * UNPACK8_OPS_PER_LEVEL,
            plain_reps=3)
        if m == 1:   # the ring's hop at w_down; the library call: one add_ with alpha
            acc = torch.zeros((rows, 512), device=dev)
            lib_acc, s1 = acc.clone(), float(sc[0])
            timings["unpack8_sum M=1 w_down accumulating"] = measure(
                timer, lambda: unpack8_sum_cuda(lv, sc, out=acc, accumulate=True),
                lambda: unpack8_sum_ref(lv, sc, out=acc, accumulate=True),
                rows * 512 + 2 * rows * 512 * 4 + 4, rows * 512 * UNPACK8_OPS_PER_LEVEL,
                plain_reps=3, library=lambda: lib_acc.add_(lv[0], alpha=s1))
            a0 = torch.randn((rows, 512), generator=gen, device=dev)
            lib = a0.clone().add_(lv[0], alpha=s1)
            k = unpack8_sum_cuda(lv, sc, out=a0.clone(), accumulate=True)
            torch.cuda.synchronize()
            differ = int((bits(lib) != bits(k)).sum())
            timings["unpack8_sum M=1 w_down accumulating"]["library_differs"] = differ
            print(f"[pack8] library acc.add_(levels, alpha=s) vs unpack8_sum accumulating at "
                  f"w_down: {differ} of {rows * 512} values differ")
            del acc, lib_acc, a0, lib, k
        del lv
    print_timings(timings)
    report["pack8_timings"] = timings
    main_shape = {"pack2bit": "pack2bit w_down", "unpack2bit": "unpack2bit w_down",
                  "qsgd8_pack8": "qsgd8_pack8 w_down bf16", "unpack8_sum": "unpack8_sum M=4 w_down"}
    return errs, {k: timings[v] for k, v in main_shape.items()}


def qsgd8_scales(torch, trainer_scale: float) -> list:
    """The decode scales of qsgd8_pack8's exhaustive bf16 check: NaN, +-inf;
    +-0, -1, subnormals and 1e-30 (clamped to 1e-20); 1e-20, 1.0 and 2.0 (the
    hoisted division's limit) with their neighbours; FLT_MAX; a mantissa of
    all ones; every other power of two from 2^-70 to 2^126 with its
    neighbours; the trainer's; and 32 drawn log-uniformly."""
    f32 = torch.float32

    def around(x):
        t = torch.tensor([x], dtype=f32)
        return [float(torch.nextafter(t, torch.tensor([-math.inf]))),
                float(t), float(torch.nextafter(t, torch.tensor([math.inf])))]

    out = [math.nan, math.inf, -math.inf, 0.0, -0.0, -1.0, 1e-45, 1e-40, 1e-30,
           ALL_ONES_MANTISSA, 3.4028234663852886e38, trainer_scale]
    for x in (1e-20, 1.0, 2.0):
        out += around(x)
    for k in range(-70, 127, 2):
        out += around(2.0**k)
    gen = torch.Generator().manual_seed(18)
    out += (10.0 ** (torch.rand(32, generator=gen, dtype=torch.float64) * 40 - 30)).tolist()
    return out


def qsgd8_exhaustive(torch, gen, errs) -> None:
    """qsgd8_pack8 against its plain version on the card, bit for bit, where
    csrc/pack8.cu's level arithmetic has its edges: every bf16 bit pattern at
    each of qsgd8_scales; every float32 bit pattern in 2^28-value chunks whose
    counter bases run on, at the trainer's scale, 1e-20, 1.0, a mantissa of
    all ones (the hoisted division) and 3.0 (__fdiv_rn); sizes about a tile
    (8,192 coordinates) and a canonical row; a gradient one element off
    16-byte alignment; a counter base that wraps inside a tile."""
    from repro_torch.core.compressors import qsgd8_scale
    from repro_torch.kernels.common import canonical_rows
    from repro_torch.kernels.pack8.ops import qsgd8_pack8_op
    from repro_torch.kernels.pack8.ref import qsgd8_pack8_ref

    dev = "cuda"
    t0 = time.perf_counter()

    def case(label, g, scale, seed, cb=0):
        k = qsgd8_pack8_op(g, scale, seed, cb)
        r = chunked_plain(qsgd8_pack8_ref, g, scale, seed, cb).reshape(-1, 512)
        torch.cuda.synchronize()
        check(k.shape == (canonical_rows(g.numel()), 512) and same_bits(k, r),
              f"qsgd8_pack8 {label} scale={scale!r} cb={cb} differs from its plain version in "
              f"{int((k != r).sum()) if k.shape == r.shape else 'shape'} bytes")
        errs["qsgd8_pack8"] = max(errs["qsgd8_pack8"], max_abs_err(k, r))

    trainer = (torch.randn(N_WDOWN // 64, generator=gen, device=dev) * 1e-3).to(torch.bfloat16)
    trainer_scale = float(qsgd8_scale(trainer))
    del trainer
    every_bf16 = torch.arange(-2**15, 2**15, dtype=torch.int16, device=dev).view(torch.bfloat16)
    scales = qsgd8_scales(torch, trainer_scale)
    for i, scale in enumerate(scales):
        case("every bf16", every_bf16, scale, 0x9E3779B9 ^ i, (7919 * i) & 0xFFFFFFFF)
    print(f"[pack8] qsgd8_pack8 every bf16 bit pattern at {len(scales)} scales: bitwise ok")

    chunk = 1 << 28
    for scale in (trainer_scale, 1e-20, 1.0, ALL_ONES_MANTISSA, 3.0):
        for c in range(0, 1 << 32, chunk):
            lo = c - (1 << 32) * (c >= 1 << 31)   # the bit patterns as int32 values
            every_f32 = torch.arange(lo, lo + chunk, dtype=torch.int64, device=dev).to(
                torch.int32).view(torch.float32)
            case("every f32", every_f32, scale, 12345, c)
            del every_f32
    print(f"[pack8] qsgd8_pack8 every float32 bit pattern (chunks of 2^28, counters running "
          f"on) at scales {trainer_scale:.6g}, 1e-20, 1, {ALL_ONES_MANTISSA!r}, 3: "
          f"bitwise ok")

    for dtype in (torch.bfloat16, torch.float32):
        for n in (1, 511, 512, 513, 8191, 8192, 8193, 3 * 8192 + 17):
            g = (torch.randn(n + 1, generator=gen, device=dev) * 0.5)
            g[1:9] = torch.tensor([0.0, -0.0, math.nan, math.inf, -math.inf, 1e-40, -1e30,
                                   -0.0], device=dev)[:n]
            g = g.to(dtype)
            for scale in (trainer_scale, 0.01, 3.0):
                case(f"n={n} {dtype}", g[1:].clone(), scale, 77, 5)
                case(f"n={n} {dtype} off 16-byte alignment", g[1:], scale, 77, 5)
            case(f"n={n} {dtype} counter wrapping", g[1:].clone(), 0.01, 78, 2**32 - 7)
    print(f"[pack8] qsgd8_pack8 sizes 1, 511-513, 8191-8193, 24593, off 16-byte alignment, "
          f"counter base 2^32 - 7 (f32, bf16): bitwise ok; exhaustive checks "
          f"{time.perf_counter() - t0:.1f} s")


def phase_golomb_two_pass(torch, report, totals):
    """engine.compress_leaf's two-pass chain on the golomb wire, the path a
    golomb-format row without a fused kernel takes (no registered row does):
    the sparsign kernel, then golomb_pack, at w_down in bf16 with a
    target_sparsity budget. Counted with every plain version barred, and
    byte for byte the fused kernel's message."""
    from repro_torch import kernels
    from repro_torch.core import engine
    from repro_torch.core.algorithm import CompressionConfig
    from repro_torch.core.budgets import BudgetConfig
    from repro_torch.core.compressors import SPECS
    from repro_torch.dist.collectives import make_vote_wire
    from repro_torch.launch.mesh import make_mesh

    name = "sparsign_golomb_two_pass"
    SPECS[name] = dataclasses.replace(SPECS["sparsign_golomb"], name=name, fused_pack_op=None)
    try:
        wire = make_vote_wire("allgather_packed", make_mesh((4,), ("data",)),
                              wire_format="golomb", golomb_p=GOLOMB_P)
        gen = torch.Generator(device="cuda").manual_seed(3)
        g = (torch.randn(N_WDOWN, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        cfg = CompressionConfig(compressor=name,
                                budget=BudgetConfig(kind="target_sparsity", value=GOLOMB_P))
        kernels.reset_launch_counts()
        with plain_versions_barred():
            two = engine.compress_leaf(g, cfg, 1234, wire=wire).values
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check(counts == expected(sparsign=1, golomb_pack=1),
              f"the two-pass chain launched {counts}")
        for k in totals:
            totals[k] += counts[k]
        fused = engine.compress_leaf(g, dataclasses.replace(cfg, compressor="sparsign_golomb"),
                                     1234, wire=wire).values
        torch.cuda.synchronize()
        check(same_bits(two, fused), "the two-pass chain's message differs from the fused one")
        report["golomb_two_pass"] = {"launches": counts, "header": golomb_header(two)}
        print(f"[golomb] engine two-pass chain (sparsign, golomb_pack) at w_down: launches "
              f"{ {k: v for k, v in counts.items() if v} }, bytes == the fused kernel's, "
              f"header {golomb_header(two)}")
    finally:
        del SPECS[name]



RING_ROWS = (256, 8192)      # JAX's default chunk, and the trainer's ring runs'
RING_WEIGHTS = (1.5, 0.5, 2.0, 1.0)   # dyadic: every order of sums is exact
RING_ORDER = (0, 3, 2, 1)    # one process of 4 workers: worker 0, then 3, 2, 1
RING_BUDGET = 0.06           # sparsign at about 4.8 % density on N(0, 1) gradients
DECODERS = {"pack2": ("unpack2bit_sum", "unpack2bit_wsum"),
            "golomb": ("ungolomb_sum", "ungolomb_wsum"), "pack8": ("unpack8_sum", None)}


def pack8_ring_bound(torch, scales) -> float:
    """The most two orders of the same M rounded products s_m * l_m (|l_m| <=
    127) can differ by: each sum of M terms is within gamma_{M-1} * sum |t|
    of the exact sum (Higham, Accuracy and Stability, 4.2), so two orders
    differ by at most 2 (M - 1) u / (1 - (M - 1) u) * 127 * sum |s_m|, u =
    2^-24."""
    m = scales.numel()
    u = 2.0 ** -24
    gamma = (m - 1) * u / (1 - (m - 1) * u)
    return 2 * gamma * 127 * float(scales.abs().to(torch.float64).sum())


def phase_ring(torch, timer, report, dev="cuda", n=N_WDOWN, layer_shapes=None):
    """The ring gather at w_down (N_WDOWN coordinates, bf16) with M = 4 real
    encoder messages (sparsign_pack2bit, sparsign_golomb at p = 0.05,
    qsgd8_pack8), each worker's from its own gradient: per leaf at 256 and
    8,192 rows against the monolithic gather (pack2 and golomb bit for bit,
    plain and with dyadic weights; pack8 bit for bit against the plain
    version's sum in the ring's order and within ``pack8_ring_bound`` of the
    monolithic sum); one bucket of the first block's leaves against the
    per-leaf exchanges on each wire, monolithic and ringed; launches counted
    (chunks x M decodes), exchanges timed (host clock to a sync, the ring's
    launches bound by the host), and the per-hop work timed alone: one
    chunk's M = 1 decode and its add into the accumulator. ``dev``, ``n``
    and ``layer_shapes`` let the phase rehearse on the CPU at a small size."""
    from repro_torch import kernels
    from repro_torch.configs.registry import get_config
    from repro_torch.core import engine
    from repro_torch.core.algorithm import CompressionConfig
    from repro_torch.core.budgets import BudgetConfig
    from repro_torch.core.compressors import tree_leaves
    from repro_torch.dist import bucketing, collectives
    from repro_torch.kernels.golomb.ops import ungolomb_sum_op, ungolomb_wsum_op
    from repro_torch.kernels.pack2bit.ops import unpack2bit_sum_op, unpack2bit_wsum_op
    from repro_torch.kernels.pack8.ops import unpack8_sum_op
    from repro_torch.kernels.pack8.ref import unpack8_sum_ref
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model

    t_phase = time.perf_counter()
    m = 4
    group = make_host_mesh(m)
    gen = torch.Generator(device=dev).manual_seed(8)
    budget = BudgetConfig(value=RING_BUDGET)
    comps = {"pack2": CompressionConfig(compressor="sparsign", budget=budget),
             "golomb": CompressionConfig(compressor="sparsign_golomb", budget=budget),
             "pack8": CompressionConfig(compressor="qsgd8", server="mean")}
    weights = torch.tensor(RING_WEIGHTS, dtype=torch.float32, device=dev)
    out = {"n": n, "per_leaf": [], "per_hop": [], "bucket": []}

    def wire(fmt, ring=None, elastic=False):
        part = collectives.ParticipationSpec(weights=RING_WEIGHTS) if elastic else None
        return collectives.make_vote_wire(
            "allgather_packed", group, wire_format=fmt, ring_chunk_rows=ring,
            golomb_p=GOLOMB_P if fmt == "golomb" else None, participation=part)

    def encode(shapes, seed):
        """{fmt: ([per shape: [M messages]], [per shape: (M,) scales])}, each
        worker's gradient N(0, 1) in bf16, drawn once for the three wires."""
        msgs = {f: [[None] * m for _ in shapes] for f in comps}
        scales = {f: [[None] * m for _ in shapes] for f in comps}
        for k, shape in enumerate(shapes):
            for j in range(m):
                g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                for f, comp in comps.items():
                    c = engine.compress_leaf(g, comp, seed + 97 * k + j, wire=wire(f))
                    msgs[f][k][j], scales[f][k][j] = c.values, c.scale.reshape(())
                del g
        return msgs, {f: [torch.stack(s) for s in v] for f, v in scales.items()}

    def exchange(wr, values, size, sc, elastic):
        if elastic:
            return wr.exchange_weighted(values, size, (size,), weight=weights, scale=sc)[0]
        return wr.exchange(values, size, (size,), scale=sc)

    def counted(fn, decoder, want, label):
        kernels.reset_launch_counts()
        res = fn()
        sync(torch)
        got = kernels.launch_counts()[decoder]
        check(got == want, f"ring {label}: {decoder} launched {got} times, expected {want}")
        return res

    def time_host(fn, reps=2):
        """Host ms of calls ending in a sync: the ring's launches are host-bound."""
        ts = []
        for _ in range(reps):
            sync(torch)
            t0 = time.perf_counter()
            fn()
            sync(torch)
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    # -- per leaf at w_down
    msgs, scales = encode([(n,)], 1)
    for fmt in ("pack2", "golomb", "pack8"):
        values, sc = msgs[fmt][0], scales[fmt][0]
        wsc = sc if fmt == "pack8" else None
        for elastic in ((False, True) if fmt != "pack8" else (False,)):
            decoder = DECODERS[fmt][int(elastic)]
            stack = torch.stack(values)
            mono = exchange(wire(fmt, None, elastic), stack, n, wsc, elastic)
            mono_ms = time_host(lambda: exchange(wire(fmt, None, elastic), stack, n, wsc,
                                                 elastic))
            del stack
            if fmt == "pack8":   # the plain version's sums in the ring's order
                want = None
                for k in RING_ORDER:
                    d = unpack8_sum_ref(values[k][None], sc[k:k + 1]).reshape(-1)[:n]
                    want = d if want is None else want + d
                    del d
                pbound = pack8_ring_bound(torch, sc)
            for rows in RING_ROWS:
                wr = wire(fmt, rows, elastic)
                chunks = wr.ring_chunks(n)
                got = counted(lambda: exchange(wr, values, n, wsc, elastic), decoder,
                              chunks * m, f"{fmt} n={n} rows={rows}")
                line = {"wire": fmt, "elastic": elastic, "rows": rows, "chunks": chunks,
                        "launches": chunks * m, "mono_ms": mono_ms}
                if rows == RING_ROWS[1] and dev == "cuda":
                    # every device activity of one exchange: on the fused
                    # wires the decodes, and W's M - 1 adds once an exchange
                    split = launch_split(torch, lambda: exchange(wr, values, n, wsc, elastic))
                    others = sum(c for name, c, _ in split if f"{decoder}_kernel" not in name)
                    line.update(activities=split, other_activities=others)
                    if fmt != "golomb":
                        check(others <= (m - 1 if elastic else 0),
                              f"{fmt} ring rows={rows} elastic={elastic}: {others} device "
                              f"activities besides the decodes: {split}")
                if fmt == "pack8":
                    check(same_bits(got, want), f"pack8 ring rows={rows} differs from the "
                                                f"plain sum in the ring's order")
                    diff = (got.to(torch.float64) - mono.to(torch.float64)).abs()
                    line.update(differ=int((bits(got) != bits(mono)).sum()),
                                max_abs_diff=float(diff.max()), bound=pbound)
                    check(line["max_abs_diff"] <= pbound,
                          f"pack8 ring rows={rows}: {line['max_abs_diff']} from the monolithic "
                          f"sum, beyond the bound {pbound}")
                    del diff
                else:
                    check(same_bits(got, mono), f"{fmt} ring rows={rows} elastic={elastic} "
                                                f"differs from the monolithic gather")
                del got
                # one timed call at 256 rows (the phase's time), two at 8,192
                line["ring_ms"] = time_host(lambda: exchange(wr, values, n, wsc, elastic),
                                            reps=1 if rows == RING_ROWS[0] else 2)
                out["per_leaf"].append(line)
                extra = (f"; {line['differ']} of {n} coordinates differ from the monolithic "
                         f"sum, at most {line['max_abs_diff']:.3e} (bound {pbound:.3e})"
                         if fmt == "pack8" else ", bitwise the monolithic gather")
                print(f"[ring] {fmt}{' weighted' if elastic else ''} w_down rows={rows}: "
                      f"{chunks} chunks, {chunks * m} {decoder} launches, ring "
                      f"{line['ring_ms']:.1f} ms, monolithic {mono_ms:.1f} ms (host to a "
                      f"sync){extra}")
            del mono
        # the per-hop work alone (device time): one chunk's M = 1 decode and
        # its add into the accumulator, the parent's hop; and the fused hop,
        # the decode added into the accumulator in place (2-bit and pack8)
        for rows in ((None,) if fmt == "golomb" else RING_ROWS):
            # a golomb leaf rides the ring as one chunk: its whole message
            nr = values[0].shape[0] if rows is None else min(rows, values[0].shape[0])
            size = n if rows is None else nr * 512
            one = values[0][:nr]
            # the ring's accumulators: _sum_dtype(4) = int8 for the 2-bit sum
            acc = {dt: torch.zeros(size, dtype=getattr(torch, dt), device=dev)
                   for dt in ("int8", "int32", "float32")}
            calls = {"pack2": [("unpack2bit_sum", "int32", "int8", lambda **k: unpack2bit_sum_op(
                                   one[None], size, (size,), **k)),
                               ("unpack2bit_wsum", "float32", "float32",
                                lambda **k: unpack2bit_wsum_op(one[None], weights[:1], size,
                                                               (size,), **k))],
                     "golomb": [("ungolomb_sum", "int32", None, lambda: ungolomb_sum_op(
                                    one[None], size, (size,), p=GOLOMB_P)),
                                ("ungolomb_wsum", "float32", None, lambda: ungolomb_wsum_op(
                                    one[None], weights[:1], size, (size,), p=GOLOMB_P))],
                     "pack8": [("unpack8_sum", "float32", "float32", lambda **k: unpack8_sum_op(
                                   one[None], sc[:1], size, (size,), **k))]}[fmt]
            # the parent's add reads two tensors, the accumulator and the decode
            dec = {dt: torch.ones(size, dtype=getattr(torch, dt), device=dev)
                   for dt in ("int32", "float32")}
            for name, add, into, fn in calls:
                t_dec = timer(fn)
                t_add = timer(lambda a=acc[add], d=dec[add]: a + d)
                # bounds: the message read and the sums written; two reads and a
                # write; the fused hop reads the message and the accumulator
                # and writes the accumulator
                msg = one.numel() * one.element_size()
                b_dec = bound(msg + 4 * size, 0)[0]
                b_add = bound(3 * 4 * size, 0)[0]
                line = {"kernel": name, "rows": rows, "coords": size, "decode_ms": t_dec["ms"],
                        "decode_bound_ms": b_dec, "add_ms": t_add["ms"], "add_bound_ms": b_add,
                        "add_dtype": add}
                what = "a whole message" if rows is None else f"a chunk of {rows} rows"
                fused = ""
                if into:
                    a = acc[into]
                    t_hop = timer(lambda: fn(out=a, accumulate=True))
                    b_hop = bound(msg + 2 * size * a.element_size(), 0)[0]
                    parent = t_dec["ms"] + t_add["ms"]
                    line.update(hop_ms=t_hop["ms"], hop_bound_ms=b_hop, hop_dtype=into,
                                hop_of_parent=t_hop["ms"] / parent if parent else None)
                    fused = (f"; fused hop into {into} {t_hop['ms']:.4f} ms (bound "
                             f"{b_hop:.4f}), {line['hop_of_parent'] or 0:.1%} of decode + add")
                out["per_hop"].append(line)
                print(f"[ring] per hop, {name} M = 1 on {size} coordinates ({fmt}, {what}): "
                      f"decode {t_dec['ms']:.4f} ms (bound {b_dec:.4f}), {add} add into the "
                      f"accumulator {t_add['ms']:.4f} ms (bound {b_add:.4f}){fused}")
            del acc, dec
    del msgs, scales

    # -- one bucket of the first block's leaves, each wire, against the
    # per-leaf exchanges (monolithic, and ringed at 256 rows)
    if layer_shapes is None:
        blocks = Model(get_config("qwen1.5-4b", smoke=False)).param_shapes()["blocks"]
        layer_shapes = [tuple(s.shape[1:]) for s in tree_leaves(blocks)]
    msgs, scales = encode(layer_shapes, 7)
    rows = RING_ROWS[0]
    for fmt in ("pack2", "golomb", "pack8"):
        mono_w, ring_w = wire(fmt, None), wire(fmt, rows)
        plan = bucketing.build_bucket_plan(
            layer_shapes, fmt, rows_fn=mono_w.payload_rows if fmt == "golomb" else None)
        (b,) = plan.buckets
        payload = torch.stack([bucketing.assemble_bucket(
            [bucketing.as_rows(msgs[fmt][s.index][j], fmt, s.rows) for s in b.slots], b, fmt)
            for j in range(m)])
        sc = (torch.stack([scales[fmt][s.index] for s in b.slots], dim=1)
              if fmt == "pack8" else None)
        if fmt == "pack2":
            launches = ring_w.bucket_ring_chunks(b) * m
        elif fmt == "golomb":
            launches = len(b.slots) * m
        else:
            launches = m * sum(len(collectives._chunk_segments(b.slots, r0, nr))
                               for r0, nr in collectives._ring_chunk_spans(b.rows, rows))
        decoder = DECODERS[fmt][0]
        got_mono = counted(lambda: mono_w.exchange_bucket(payload, b, scale=sc), decoder,
                           1 if fmt == "pack2" else len(b.slots), f"{fmt} bucket monolithic")
        got_ring = counted(lambda: ring_w.exchange_bucket(payload, b, scale=sc), decoder,
                           launches, f"{fmt} bucket rows={rows}")
        ms = {"mono_ms": time_host(lambda: mono_w.exchange_bucket(payload, b, scale=sc)),
              "ring_ms": time_host(lambda: ring_w.exchange_bucket(payload, b, scale=sc))}
        for s, a, r in zip(b.slots, got_mono, got_ring):
            k = s.index
            wsc = scales[fmt][k] if fmt == "pack8" else None
            leaf_mono = mono_w.exchange(torch.stack(msgs[fmt][k]), s.size, s.shape, scale=wsc)
            leaf_ring = ring_w.exchange(msgs[fmt][k], s.size, s.shape, scale=wsc)
            check(same_bits(a, leaf_mono), f"{fmt} bucket slot {k} differs from the per-leaf "
                                           f"monolithic exchange")
            check(same_bits(r, leaf_ring), f"{fmt} bucket ring slot {k} differs from the "
                                           f"per-leaf ring")
        out["bucket"].append({"wire": fmt, "slots": len(b.slots), "rows": b.rows,
                              "coords": sum(s.size for s in b.slots), "ring_rows": rows,
                              "launches": launches, **ms})
        print(f"[ring] {fmt} bucket of the first block's {len(b.slots)} leaves ({b.rows} rows): "
              f"monolithic and ringed ({rows} rows, {launches} {decoder} launches) bitwise the "
              f"per-leaf exchanges; {ms['mono_ms']:.1f} ms and {ms['ring_ms']:.1f} ms")
        del payload, got_mono, got_ring
    del msgs, scales
    out["seconds"] = time.perf_counter() - t_phase
    report["ring"] = out
    print(f"[ring] phase {out['seconds']:.1f} s")


def sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def plain_versions_barred():
    """Every plain version of a kernel on the trainer's and the server's
    paths raises while the block runs, so a counted run shows that none ran
    on the card."""
    import repro_torch.core.engine as engine_mod
    import repro_torch.dist.collectives as coll_mod
    import repro_torch.kernels.pack2bit.ops as pack_ops
    import repro_torch.kernels.sparsign.ops as sparsign_ops
    import repro_torch.kernels.sparsign_pack2bit.ops as spack_ops
    import repro_torch.kernels.ternary.ops as ternary_ops
    import repro_torch.kernels.vote_update.ops as vote_ops
    import repro_torch.kernels.ef_server.ops as ef_ops
    import repro_torch.kernels.golomb.ops as golomb_ops
    import repro_torch.kernels.pack8.ops as pack8_ops
    import repro_torch.serve.decode as serve_mod

    names = [(engine_mod, "pack2bit_ref"), (engine_mod, "vote_update_ref"),
             (engine_mod, "golomb_encode_ref"), (coll_mod, "ungolomb_sum_ref"),
             (coll_mod, "ungolomb_wsum_ref"), (golomb_ops, "golomb_encode_ref"),
             (golomb_ops, "sparsign_golomb_ref"), (golomb_ops, "ungolomb_sum_ref"),
             (golomb_ops, "ungolomb_wsum_ref"),
             (engine_mod, "weighted_vote_update_ref"), (engine_mod, "ef_server_ref"),
             (coll_mod, "unpack2bit_sum_ref"), (coll_mod, "unpack2bit_wsum_ref"),
             (pack_ops, "unpack2bit_sum_ref"), (pack_ops, "unpack2bit_wsum_ref"),
             (sparsign_ops, "sparsign_ref"),
             (spack_ops, "sparsign_pack2bit_ref"), (ternary_ops, "ternary_compress_ref"),
             (ternary_ops, "ternary_pack2bit_ref"), (vote_ops, "vote_update_ref"),
             (vote_ops, "weighted_vote_update_ref"), (ef_ops, "ef_server_ref"),
             (pack_ops, "pack2bit_ref"), (pack_ops, "unpack2bit_ref"),
             (pack8_ops, "qsgd8_pack8_ref"), (pack8_ops, "unpack8_sum_ref"),
             (coll_mod, "unpack8_sum_ref"), (serve_mod, "pack2bit_ref"),
             (serve_mod, "unpack2bit_ref"), (serve_mod, "qsgd8_levels_ref")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in names]

    def barred(label):
        def fn(*a, **k):
            raise RuntimeError(f"a plain version ran on the trainer's path: {label}")
        return fn

    try:
        for mod, name, _ in saved:
            setattr(mod, name, barred(f"{mod.__name__}.{name}"))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def time_bisection(torch, model, workers: int) -> float:
    """Device ms of the target_sparsity budget's bisection
    (budgets.solve_budget_for_sparsity at GOLOMB_P) over every leaf of the
    model, once a worker: random bf16 gradients of each leaf's shape, one
    leaf at a time, CUDA events around each solve."""
    from repro_torch.core.budgets import solve_budget_for_sparsity
    from repro_torch.core.compressors import tree_leaves

    gen = torch.Generator(device="cuda").manual_seed(4)
    total = 0.0
    for sd in tree_leaves(model.param_shapes()):
        g = (torch.randn(sd.shape, generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
        solve_budget_for_sparsity(g, GOLOMB_P)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        solve_budget_for_sparsity(g, GOLOMB_P)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
        del g
    return total * workers


def ulps_apart(torch, a, b) -> tuple:
    """(coordinates that differ, the largest difference in ulps) of two
    bf16 or float32 tensors: each bit pattern mapped to its place on the
    number line."""
    wide = a.dtype == torch.float32
    mag = 0x7FFFFFFF if wide else 0x7FFF

    def order(t):
        v = t.view(torch.int32 if wide else torch.int16).to(torch.int64)
        return torch.where(v < 0, -(v & mag), v)

    d = (order(a) - order(b)).abs()
    return int((d != 0).sum()), int(d.max()) if d.numel() else 0


def ring_run_launches(step, model, m: int, leaves: int) -> dict:
    """Launches a step of a bucketed or ring run implies, from its plan and
    wire: the encoder once a worker and leaf; the decode-sum at M = 1 once a
    worker and ring chunk (a golomb bucket: once a worker and slot, each
    slot its own stream); the vote server once a leaf."""
    from repro_torch.core.compressors import tree_leaves

    wire, plan = step.wire, step.plan
    if wire.native_format == "pack8":
        chunks = sum(wire.ring_chunks(math.prod(sd.shape))
                     for sd in tree_leaves(model.param_shapes()))
        return dict(qsgd8_pack8=leaves * m, unpack8_sum=chunks * m)
    if wire.native_format == "golomb":
        return dict(sparsign_golomb=leaves * m, ungolomb_sum=plan.n_slots * m,
                    vote_update=plan.n_slots)
    return dict(sparsign_pack2bit=leaves * m, vote_update=plan.n_slots,
                unpack2bit_sum=m * sum(wire.bucket_ring_chunks(b) for b in plan.buckets))


# the depth of the trainer phase's variant runs (elastic, bucketed, ring)
# and of the monolithic golomb and pack8 runs their rings are held against:
# a tenth of qwen1.5-4b's 40 layers, at its full width
VARIANT_LAYERS = 4


def phase_trainer(torch, report, totals):
    """qwen1.5-4b at full width through repro_torch.launch.train, M = 4
    workers on the card, 2 steps a run (5 runs 1 step); the variant runs
    and their references VARIANT_LAYERS layers deep."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import engine
    from repro_torch.core.compressors import tree_leaves
    from repro_torch.dist import bucketing, collectives
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import loop

    m, leaves = 4, 15
    base = ["--arch", "qwen1.5-4b", "--full", "--host-data", str(m), "--batch", str(m),
            "--seq-len", str(TRAINER_SEQ_LEN), "--seed", "0"]
    sparsign = ["--compressor", "sparsign", "--budget-kind", "l2_norm", "--budget", "0.1"]
    target = ["--budget-kind", "target_sparsity", "--budget", str(GOLOMB_P)]
    elastic = ["--worker-weights", "1.5,0.5,2,1", "--dropout", "0.25"]
    majority = ["--server", "majority_vote"]
    packed = ["--vote-impl", "allgather_packed"]
    ring = ["--ring", "--ring-chunk-rows", str(RING_ROWS[1])]
    voted = dict(unpack2bit_sum=leaves, vote_update=leaves)
    golomb_voted = dict(sparsign_golomb=leaves * m, ungolomb_sum=leaves, vote_update=leaves)
    qsgd8 = ["--compressor", "qsgd8", "--server", "mean"]
    golomb = "sparsign_golomb/majority_vote allgather_packed"
    pack8 = "qsgd8/mean allgather_packed (pack8)"
    cut = f" ({VARIANT_LAYERS} layers)"
    runs = [  # label, flags, worker group (None: --host-data), launches a step (None:
              # ring_run_launches), steps, layers (None: all 40)
        ("sparsign/majority_vote allgather_packed", sparsign + majority + packed, None,
         dict(sparsign_pack2bit=leaves * m, **voted), 2, None),
        # the three vote wires held bit for bit, and the EF server,
        # VARIANT_LAYERS deep: they pay for the streamed phase's runs under
        # the 'model' axis (a leaf's launches do not depend on the depth)
        ("sparsign/majority_vote psum" + cut, sparsign + majority + ["--vote-impl", "psum"],
         None, dict(sparsign=leaves * m, vote_update=leaves), 2, VARIANT_LAYERS),
        ("sparsign/majority_vote hier 2x2" + cut, sparsign + majority + ["--vote-impl", "hier"],
         ((2, 2), ("pod", "data")), dict(sparsign=leaves * m, vote_update=leaves), 2,
         VARIANT_LAYERS),
        ("sparsign/majority_vote allgather_packed" + cut, sparsign + majority + packed, None,
         dict(sparsign_pack2bit=leaves * m, **voted), 2, VARIANT_LAYERS),
        ("sparsign/scaled_sign_ef allgather_packed" + cut, sparsign
         + ["--server", "scaled_sign_ef"] + packed, None,
         dict(sparsign_pack2bit=leaves * m, unpack2bit_sum=leaves, ef_server=leaves), 2,
         VARIANT_LAYERS),
        # one step each, as the elastic runs: their launches are per step, no
        # run is held against them, and the run must make room for the
        # mamba2-370m, checkpoint and zoo phases; VARIANT_LAYERS deep, which
        # pays for phase_tp (a leaf's launches do not depend on the depth)
        ("sign/majority_vote allgather_packed" + cut, ["--compressor", "sign"] + majority
         + packed, None, dict(ternary_pack2bit=leaves * m, **voted), 1, VARIANT_LAYERS),
        ("noisy_sign/majority_vote allgather_packed" + cut,
         ["--compressor", "noisy_sign", "--budget", "1e-4"] + majority + packed, None,
         dict(ternary_pack2bit=leaves * m, **voted), 1, VARIANT_LAYERS),
        ("terngrad/mean allgather_packed" + cut, ["--compressor", "terngrad", "--server",
                                                  "mean"] + packed, None,
         dict(ternary_pack2bit=leaves * m, unpack2bit_sum=leaves), 1, VARIANT_LAYERS),
        # the variant runs, cut to VARIANT_LAYERS layers so the zoo's phases
        # fit the time: elastic, bucketed and ring, and the monolithic runs
        # the rings are held against at the same depth
        ("elastic sparsign/majority_vote allgather_packed" + cut, sparsign + majority + packed
         + elastic, None, dict(sparsign_pack2bit=leaves * m, unpack2bit_wsum=leaves,
                               weighted_vote_update=leaves), 1, VARIANT_LAYERS),
        ("elastic " + golomb + cut,
         ["--compressor", "sparsign_golomb"] + target + majority + packed + elastic, None,
         dict(sparsign_golomb=leaves * m, ungolomb_wsum=leaves, weighted_vote_update=leaves),
         2, VARIANT_LAYERS),
        (golomb + cut, ["--compressor", "sparsign_golomb"] + target + majority + packed, None,
         golomb_voted, 2, VARIANT_LAYERS),
        ("sparsign target_sparsity/majority_vote allgather_packed bucketed ring" + cut,
         ["--compressor", "sparsign"] + target + majority + packed + ["--bucketed"] + ring,
         None, None, 2, VARIANT_LAYERS),
        (golomb + " bucketed ring" + cut,
         ["--compressor", "sparsign_golomb"] + target + majority + packed + ["--bucketed"]
         + ring, None, None, 2, VARIANT_LAYERS),
        (pack8 + cut, qsgd8 + packed, None, dict(qsgd8_pack8=leaves * m, unpack8_sum=leaves),
         2, VARIANT_LAYERS),
        (pack8 + " ring" + cut, qsgd8 + packed + ring, None, None, 2, VARIANT_LAYERS),
        # held against the pack8 run at the same depth (VARIANT_LAYERS, which
        # pays for phase_tp)
        ("qsgd8/mean psum (decoded)" + cut, qsgd8 + ["--vote-impl", "psum"], None,
         dict(qsgd8_pack8=leaves * m), 2, VARIANT_LAYERS),
        ("elastic " + pack8 + cut, qsgd8 + packed + elastic, None,
         dict(qsgd8_pack8=leaves * m, unpack8_sum=leaves), 1, VARIANT_LAYERS),
    ]
    # the runs held against a reference run's parameters (held on the host,
    # so the card's peaks exclude them): bit for bit, the three vote wires;
    # the golomb wire and the 2-bit wire, per leaf and bucketed on the ring
    # (the same votes on two encodings, while no golomb message drops a
    # nonzero); the pack8 wire and the decoded psum (the same float sums in
    # worker order). The pack8 ring sums in ring order: its difference is
    # printed in bf16 ulps (its sums are held bit for bit in the ring phase)
    ring2 = "sparsign target_sparsity/majority_vote allgather_packed bucketed ring" + cut
    compare = {"sparsign/majority_vote hier 2x2" + cut: ("sparsign/majority_vote psum" + cut,
                                                         "bits"),
               "sparsign/majority_vote allgather_packed" + cut: (
                   "sparsign/majority_vote psum" + cut, "bits"),
               ring2: (golomb + cut, "bits"),
               golomb + " bucketed ring" + cut: (golomb + cut, "bits"),
               "qsgd8/mean psum (decoded)" + cut: (pack8 + cut, "bits"),
               pack8 + " ring" + cut: (pack8 + cut, "ulps")}
    # each ring run's peak memory beside its monolithic twins': the same
    # wire's, and the golomb run (the same budget, whose bisection sets it)
    mono_of = {ring2: (golomb + cut,), golomb + " bucketed ring" + cut: (golomb + cut,),
               pack8 + " ring" + cut: (pack8 + cut,)}
    traced_runs = {"sparsign/majority_vote allgather_packed": "trainer_profile",
                   golomb + cut: "trainer_profile_golomb"}
    check(set(compare) | {r for r, _ in compare.values()} | set(traced_runs)
          <= {r[0] for r in runs}, "phase_trainer: a compared or traced run is not in the list")
    held, peaks_of, losses_of = {}, {}, {}
    get_config = launch.get_config
    for label, flags, mesh, per_step, steps, layers in runs:
        args = launch.parser().parse_args(base + flags + ["--steps", str(steps)])
        group = make_mesh(*mesh) if mesh is not None else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if layers is not None:
            launch.get_config = lambda arch, smoke: dataclasses.replace(
                get_config(arch, smoke=smoke), n_layers=layers)
        try:
            cfg, model, group, step, state, comp = launch.build_everything(args, group=group)
        finally:
            launch.get_config = get_config
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        batch_fn = launch.batch_fn_for(cfg, args)
        if per_step is None:
            per_step = ring_run_launches(step, model, m, leaves)
        peaks = []   # GB at each log point, just after the step's sync
        kernels.reset_launch_counts()
        with plain_versions_barred():
            state, history = loop.run(
                step, state, batch_fn, loop.LoopConfig(total_steps=steps, log_every=1),
                log=lambda line: peaks.append(torch.cuda.max_memory_allocated() / 1e9))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        want = expected(**{k: v * steps for k, v in per_step.items()})
        check(counts == want, f"trainer {label}: launches {counts}, expected {want}")
        for k in totals:
            totals[k] += counts[k]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        peaks_of[label] = peak_gb
        losses_of[label] = [h["loss"] for h in history]
        share = engine.needs_shared_linf(comp)
        sizes = [math.prod(sd.shape) for sd in tree_leaves(model.param_shapes())]
        if step.plan is not None:
            ledger = float(np.float32(sum(bucketing.plan_ledger(step.mode, step.wire, step.plan,
                                                                share_linf=share))))
            hbm = bucketing.plan_gather_hbm_bytes(step.mode, step.wire, step.plan)
        else:
            ledger = float(np.float32(sum(collectives.uplink_ledger(
                step.mode, step.wire, n, share_linf=share) for n in sizes)))
            hbm = (0.0 if step.mode == "decoded"
                   else max(step.wire.gather_hbm_bytes(n) for n in sizes))
        hbm = float(np.float32(hbm))
        walls = [h["wall_s"] for h in history]
        step_s = [b - a for a, b in zip([0.0] + walls[:-1], walls)]
        for h, s_, pk in zip(history, step_s, peaks):
            check(math.isfinite(h["loss"]), f"trainer {label}: non-finite loss {h['loss']}")
            check(h["wire_bytes_per_device"] == ledger,
                  f"trainer {label}: wire bytes {h['wire_bytes_per_device']} != ledger {ledger}")
            check(h["gather_hbm_bytes"] == hbm,
                  f"trainer {label}: gather_hbm_bytes {h['gather_hbm_bytes']} != the model's "
                  f"{hbm}")
            dropped = ""
            if "nnz_dropped" in h:
                check(h["nnz_dropped"] == 0, f"trainer {label}: {h['nnz_dropped']} nonzeros "
                                             f"dropped at capacity")
                dropped = f" dropped {h['nnz_dropped']:g}"
            print(f"[trainer] {label} step {h['step']}: loss {h['loss']:.6f} nnz_frac "
                  f"{h['nnz_frac']:.6g}{dropped} wire_bytes_per_device "
                  f"{h['wire_bytes_per_device']:.10g} gather_hbm_bytes "
                  f"{h['gather_hbm_bytes']:.10g} participated {h['participated']:g} host "
                  f"{s_:.3f} s peak {pk:.2f} GB")
        line = {"run": label, "layers": cfg.n_layers, "workers": m,
                "tokens_per_worker": TRAINER_SEQ_LEN, "build_s": build_s, "step_s": step_s,
                "run_s": run_s, "peak_gb": peak_gb, "loss": losses_of[label],
                "nnz_frac": [h["nnz_frac"] for h in history],
                "nnz_dropped": [h.get("nnz_dropped") for h in history],
                "participated": [h["participated"] for h in history], "peak_gb_by_step": peaks,
                "wire_bytes_per_device": ledger, "gather_hbm_bytes": hbm, "launches": counts}
        if step.plan is not None:
            line["buckets"] = [{"slots": len(b.slots), "rows": b.rows}
                               for b in step.plan.buckets]
        mono = ""
        if label in mono_of:
            line["monolithic_peak_gb"] = {t: peaks_of[t] for t in mono_of[label]}
            mono = " (monolithic: " + "; ".join(f"the {t} run {peaks_of[t]:.2f} GB"
                                               for t in mono_of[label]) + ")"
        report.setdefault("trainer", []).append(line)
        print(f"[trainer] {label}: {cfg.n_layers} layers, build {build_s:.2f} s, steps "
              f"{[round(x, 3) for x in step_s]} s, run {run_s:.1f} s, peak {peak_gb:.2f} GB"
              f"{mono}, launches { {k: v for k, v in counts.items() if v} }")
        params = tree_leaves(state.params)
        check(all(bool(torch.isfinite(p).all()) for p in params),
              f"trainer {label}: non-finite parameters")
        if any(ref == label for ref, _ in compare.values()):
            held[label] = [p.to("cpu", copy=True) for p in params]
        if label in compare:
            ref_label, how = compare[label]
            reference = held[ref_label]
            # leaf by leaf, after this run's peak was read
            if how == "bits":
                same = all(torch.equal(bits(a), bits(b.to(a.device)))
                           for a, b in zip(params, reference))
                check(same, f"trainer {label}: parameters differ from the {ref_label} run")
                print(f"[trainer] {label}: parameters bitwise equal to the {ref_label} run")
            else:
                stats = [ulps_apart(torch, a, b.to(a.device)) for a, b in zip(params, reference)]
                differ = sum(d for d, _ in stats)
                ulps = max(u for _, u in stats)
                dtype = str(params[0].dtype)[6:]
                line.update(differ_from=ref_label, differ=differ, max_ulps=ulps, ulp_dtype=dtype)
                print(f"[trainer] {label}: {differ} of {sum(sizes)} parameters differ from the "
                      f"{ref_label} run, at most {ulps} {dtype} ulps; losses {losses_of[label]} "
                      f"against {losses_of[ref_label]}")
            if not any(r == ref_label for other, (r, _) in compare.items()
                       if other not in losses_of):
                del held[ref_label]
        if label in traced_runs:
            # where a step's device time goes: one more step of this run,
            # traced after its counted steps (these launches are not counted)
            params = None
            batch = batch_fn(steps)
            split = profile_call(torch, lambda: step(state, batch))
            report[traced_runs[label]] = split
            shares = ", ".join(f"{k} {v:.3%}" for k, v in split["kernel_share"].items())
            top = ", ".join(f"{k[:60]} {v:.1%}" for k, v in split["top_kernels"].items())
            print(f"[profile] trainer step ({label}, {cfg.n_layers} layers): "
                  f"{split['call_ms']:.1f} ms, device busy {split['busy_share']:.1%}, port "
                  f"kernels {split['port_kernel_share']:.3%} of device time ({shares}); "
                  f"top: {top}")
        if label == runs[0][0]:   # majority vote: no EF state
            report["checkpoint_roundtrip"] = checkpoint_round_trip(torch, model, state)
        if label == golomb + cut:
            bisect_ms = time_bisection(torch, model, m)
            report["bisection_ms_per_step"] = bisect_ms
            print(f"[trainer] target_sparsity bisection: {bisect_ms:.1f} ms of device time a "
                  f"step ({m} workers x {leaves} leaves, 30 passes each), "
                  f"{bisect_ms / 1e3 / statistics.median(step_s):.2%} of the median step")
        del params, step, state, model
        torch.cuda.empty_cache()
    check(not held, f"reference runs never compared: {sorted(held)}")


def decode_vs_forward(torch, model, params, toks, pos, s: int, floor: bool = True) -> tuple:
    """Decode of token s after a prefill of s tokens whose cache is padded to
    s + 1 (a mamba block's conv ring and state, and a windowed layer's ring,
    copied whole), against forward_hidden's last logits over the same s + 1
    tokens:
    max |difference| over max |logit|, the same for the logits of a forward
    one token longer (other GEMM shapes: the dtype's own noise; None without
    ``floor``), and the share of the batch whose argmax agrees."""
    from repro_torch.serve.decode import build_decode_step, build_prefill

    batch, dev = toks.shape[0], toks.device

    def part(a, b):   # inputs (tokens or embeddings) a..b-1 with their positions
        out = {"inputs": toks[:, a:b], "positions": pos[:, a:b]}
        if model.cfg.mrope:   # the launcher's three equal position streams
            out["positions3"] = out["positions"][..., None].expand(-1, -1, 3)
        return out

    _, caches = build_prefill(model)(params, part(0, s))
    padded = model.init_cache(batch, s + 1, dev)
    for c, pc in zip(caches, padded):
        for key in c:   # K, V, positions: the first s slots; rings, conv, state: whole
            pc[key][:, :c[key].shape[1]] = c[key]
    del caches
    dec, _ = build_decode_step(model)(params, padded, part(s, s + 1))
    with torch.no_grad():
        if floor:
            h = model.forward_hidden(params, part(0, s + 2))
            longer = (h[:, s] @ model.head_weight(params)).to(torch.float32)
        h = model.forward_hidden(params, part(0, s + 1))
        ref = (h[:, -1] @ model.head_weight(params)).to(torch.float32)
    del h, padded
    dec = dec.to(torch.float32)

    def rel_to_ref(x):
        return float((x - ref).abs().max() / ref.abs().max())

    return (rel_to_ref(dec), rel_to_ref(longer) if floor else None,
            float((dec.argmax(-1) == ref.argmax(-1)).float().mean()))


def phase_serve(torch, report, totals):
    """Serving qwen1.5-4b at full width on the card: the launcher's loop with
    its 2-bit update rounds, counted with every plain version barred; a
    timed prefill; decode after a padded prefill against the full forward;
    one ingest round on each downlink wire against backend="torch"."""
    from repro_torch import kernels
    from repro_torch.configs.registry import get_config
    from repro_torch.core import engine
    from repro_torch.core.algorithm import CompressionConfig
    from repro_torch.core.compressors import tree_leaves
    from repro_torch.kernels.common import jnp_sign
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.model import Model
    from repro_torch.serve.decode import (build_decode_step, build_prefill,
                                          build_update_ingest, encode_weight_update,
                                          encode_weight_update8)

    leaves, dev = 15, "cuda"
    out = {}
    # -- the launcher's loop: prompt replay, 64 greedy tokens, 4 update rounds
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with plain_versions_barred():
        loop = launch_serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    rounds = loop["updates"]
    want = expected(pack2bit=leaves * rounds, unpack2bit=leaves * rounds,
                    vote_update=leaves * rounds)
    check(rounds == 4 and counts == want, f"serve loop: {rounds} rounds, launches {counts}, "
                                          f"expected {want}")
    for k in totals:
        totals[k] += counts[k]
    out["loop"] = {**loop, "launches": counts,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[serve] launch.serve {' '.join(SERVE_ARGS)}: {loop['tokens']} tokens in "
          f"{loop['seconds']:.2f} s, decode {loop['decode_ms_median']:.2f} ms a token (median "
          f"of {loop['decode_steps']} steps), packed2bit ingest ms a round "
          f"{[round(x, 2) for x in loop['ingest_ms']]}, peak {out['loop']['peak_gb']:.2f} GB, "
          f"launches { {k: v for k, v in counts.items() if v} }")

    cfg = get_config("qwen1.5-4b")
    model = Model(cfg)
    params = model.init(0, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN), generator=gen,
                         device=dev, dtype=torch.int32)
    pos = torch.arange(PREFILL_LEN, device=dev, dtype=torch.int32).expand(PREFILL_BATCH, -1)

    # -- prefill, timed after a warm-up call
    prefill = build_prefill(model)
    batch = {"inputs": toks, "positions": pos}
    logits, caches = prefill(params, batch)
    del logits, caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(tuple(logits.shape) == (PREFILL_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill: logits not finite or misshapen")
    ntok = PREFILL_BATCH * PREFILL_LEN
    out["prefill"] = {"batch": PREFILL_BATCH, "tokens": PREFILL_LEN, "seconds": prefill_s,
                      "tokens_per_s": ntok / prefill_s,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del logits, caches
    print(f"[serve] prefill {PREFILL_BATCH} x {PREFILL_LEN} tokens: {prefill_s * 1e3:.1f} ms, "
          f"{ntok / prefill_s:.0f} tokens/s, peak {out['prefill']['peak_gb']:.2f} GB")

    # -- decode after a prefill whose cache is padded to max_len, against
    # forward_hidden's last logits over the same tokens: in bf16, then once in
    # float32 (the same check with the rounding of bf16 taken away)
    s = 128
    rel, floor, agree = decode_vs_forward(torch, model, params, toks, pos, s)
    check(rel <= DECODE_REL_TOL and agree >= 0.75,
          f"decode after a padded prefill: {rel:.3g} of max |logit| from the full forward "
          f"(tolerance {DECODE_REL_TOL}), argmax agreeing for {agree:.0%}")
    out["decode_vs_forward"] = {"prompt": s, "rel_err": rel, "bf16_floor": floor,
                                "argmax_agree": agree, "tol": DECODE_REL_TOL}
    print(f"[serve] decode after a padded {s}-token prefill vs forward_hidden: max |diff| "
          f"{rel:.4g} of max |logit| (tolerance {DECODE_REL_TOL}; a forward one token longer "
          f"gives {floor:.4g}), argmax agrees for {agree:.0%} of the batch")
    t0 = time.perf_counter()
    model32 = Model(dataclasses.replace(cfg, dtype="float32"))
    params32 = model32.init(0, dev)
    gb32 = sum(x.numel() * x.element_size() for x in tree_leaves(params32)) / 1e9
    rel32, floor32, agree32 = decode_vs_forward(torch, model32, params32, toks, pos, s)
    del params32, model32
    torch.cuda.empty_cache()
    f32_s = time.perf_counter() - t0
    check(rel32 <= DECODE_F32_REL_TOL,
          f"decode after a padded prefill in float32: {rel32:.3g} of max |logit| from the full "
          f"forward (tolerance {DECODE_F32_REL_TOL})")
    out["decode_vs_forward_f32"] = {"prompt": s, "rel_err": rel32, "floor": floor32,
                                    "argmax_agree": agree32, "tol": DECODE_F32_REL_TOL,
                                    "seconds": f32_s, "weights_gb": gb32}
    print(f"[serve] the same in float32 ({f32_s:.1f} s, {gb32:.2f} GB of weights): "
          f"max |diff| {rel32:.4g} of max |logit| (tolerance {DECODE_F32_REL_TOL}; a forward "
          f"one token longer gives {floor32:.4g}), argmax agrees for {agree32:.0%}")

    # -- where a decode step's and a prefill's time goes (launches not counted)
    caches = model.init_cache(PREFILL_BATCH, s + 1, dev)
    step = build_decode_step(model)
    one = {"inputs": toks[:, :1], "positions": pos[:, :1].contiguous()}
    step(params, caches, one)
    split = profile_call(torch, lambda: step(params, caches, one))
    out["decode_profile"] = split
    print(f"[profile] decode step (batch {PREFILL_BATCH}, {cfg.n_layers} layers): "
          f"{split['call_ms']:.1f} ms, {split['kernels']} kernels, device busy "
          f"{split['busy_share']:.1%}; top: "
          + ", ".join(f"{k[:50]} {v:.1%}" for k, v in split["top_kernels"].items()))
    del caches
    split = profile_call(torch, lambda: prefill(params, batch))
    out["prefill_profile"] = split
    print(f"[profile] prefill {PREFILL_BATCH} x {PREFILL_LEN}: {split['call_ms']:.1f} ms, "
          f"device busy {split['busy_share']:.1%}; top: "
          + ", ".join(f"{k[:50]} {v:.1%}" for k, v in split["top_kernels"].items()))

    # -- one ingest round on each downlink wire: the kernels (counted, plain
    # versions barred) against backend="torch", bit for bit
    lr = 1e-4
    p0 = tree_leaves(params)

    def votes(i):
        g = torch.Generator(device=dev).manual_seed(100 + i)
        return torch.randint(-2, 3, p0[i].shape, generator=g, device=dev, dtype=torch.int32)

    def delta(i):
        g = torch.Generator(device=dev).manual_seed(200 + i)
        return torch.randn(p0[i].shape, generator=g, device=dev)

    def route(wire, backend):
        ups, scales = [], []
        t0 = time.perf_counter()
        for i in range(len(p0)):
            if wire == "packed2bit":
                ups.append(encode_weight_update(votes(i), backend=backend))
            elif wire == "int8":
                ups.append(votes(i).to(torch.int8))
            else:
                u, sc = encode_weight_update8(delta(i), seed=i, backend=backend)
                ups.append(u)
                scales.append(sc)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        ingest = build_update_ingest(model, lr=lr, quorum=2 if wire == "int8" else 1,
                                     wire=wire, backend=backend)
        p = [x.clone() for x in p0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = ingest(p, ups, scales or None)
        torch.cuda.synchronize()
        return p, ups, enc_s, time.perf_counter() - t0

    launches = {"packed2bit": dict(pack2bit=leaves, unpack2bit=leaves, vote_update=leaves),
                "int8": dict(vote_update=leaves), "packed8": dict(qsgd8_pack8=leaves)}
    out["ingest"] = {}
    for wire, per in launches.items():
        kernels.reset_launch_counts()
        with plain_versions_barred():
            got, ups_k, enc_s, ingest_s = route(wire, None)
        counts = kernels.launch_counts()
        check(counts == expected(**per), f"ingest {wire}: launches {counts}")
        for k in totals:
            totals[k] += counts[k]
        plain, ups_t, _, _ = route(wire, "torch")
        check(all(same_bits(a, b) for a, b in zip(ups_k, ups_t)),
              f"ingest {wire}: the encoded messages differ from backend='torch'")
        del ups_k, ups_t
        check(all(same_bits(a, b) for a, b in zip(got, plain)),
              f"ingest {wire}: parameters differ from backend='torch'")
        del plain
        if wire == "packed2bit":
            cfg_v = CompressionConfig(server="majority_vote")
            for i, a in enumerate(got):
                v = votes(i)
                decision = torch.where(v.abs() >= 1, jnp_sign(v), torch.zeros_like(v))
                b, _ = engine.server_apply(p0[i], decision.to(torch.int8), cfg_v, lr=lr)
                check(same_bits(a, b), f"ingest packed2bit leaf {i}: differs from server_apply "
                                       f"on the int8 decisions")
        moved = sum(int((a != b).sum()) for a, b in zip(got, p0))
        check(moved > 0, f"ingest {wire}: no coordinate moved")
        del got
        out["ingest"][wire] = {"encode_ms": enc_s * 1e3, "ingest_ms": ingest_s * 1e3,
                               "launches": counts, "coords_moved": moved}
        print(f"[serve] ingest {wire}: encode {enc_s * 1e3:.1f} ms, ingest {ingest_s * 1e3:.1f} "
              f"ms a round, {moved} coordinates moved, bitwise equal to backend='torch'"
              + (", and to server_apply on the int8 decisions" if wire == "packed2bit" else "")
              + f"; launches { {k: v for k, v in counts.items() if v} }")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["serve"] = out
    del params, p0
    torch.cuda.empty_cache()


def checkpoint_round_trip(torch, model, state) -> dict:
    """A full-width checkpoint of the trainer's state (qwen1.5-4b, majority
    vote, so no EF residual): saved into a temporary directory, restored into
    a fresh state of other values, held bit for bit; seconds and GB on disk
    of each half. The directory is removed whatever happens."""
    import tempfile

    from repro_torch.core.compressors import tree_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.state import init_state

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        sync(torch)
        t0 = time.perf_counter()
        path = ckpt.save(tmp, state.step, state)
        save_s = time.perf_counter() - t0
        gb = dir_gb(path)
        dev = tree_leaves(state.params)[0].device
        fresh = init_state(model.init(1, dev), server="majority_vote", seed=state.seed + 1)
        sync(torch)
        t0 = time.perf_counter()
        got, manifest = ckpt.restore(tmp, fresh)
        sync(torch)
        restore_s = time.perf_counter() - t0
        del fresh
        same = (got.step == state.step and got.seed == state.seed
                and all(torch.equal(bits(a), bits(b))
                        for a, b in zip(tree_leaves(got.params), tree_leaves(state.params))))
        check(same, "checkpoint round trip: the restored state differs from the saved one")
        n = sum(p.numel() for p in tree_leaves(state.params))
        out = {"leaves": manifest["n_leaves"], "parameters": n, "gb_on_disk": gb,
               "save_s": save_s, "restore_s": restore_s, "fingerprint": manifest["fingerprint"]}
        print(f"[checkpoint] qwen1.5-4b full width ({n} parameters, {manifest['n_leaves']} "
              f"leaves): save {save_s:.2f} s ({gb:.2f} GB on disk, bf16 widened to float32), "
              f"restore into a fresh state {restore_s:.2f} s, bit for bit")
        del got
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def dir_gb(path) -> float:
    return sum(f.stat().st_size for f in pathlib.Path(path).iterdir()) / 1e9


def loop_seconds(lines, what: str) -> list:
    """The seconds the loop logged for each save ("saved") or restore
    ("resumed") in ``lines``."""
    return [float(line.rsplit("(", 1)[1].split(" s)")[0])
            for line in lines if line.startswith(f"[loop] {what}")]


@contextlib.contextmanager
def stdout_lines(lines: list):
    """What the block prints, appended to ``lines`` and printed after it."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield
    finally:
        lines.extend(buf.getvalue().splitlines())
        print(buf.getvalue(), end="")


def train_in_child(argv: list, timeout: float = 300.0) -> tuple:
    """repro_torch.launch.train's main on ``argv`` in a fresh Python process
    (``chip_smoke.py --train-child``): (its launch counts, its stdout lines).
    Fails unless the child exits 0."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--train-child"]
                          + list(argv), capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT)
    lines = proc.stdout.splitlines()
    print("\n".join(lines[:-1]))
    check(proc.returncode == 0 and lines, f"the child trainer exited {proc.returncode}: "
                                          f"{proc.stderr[-2000:]}")
    return json.loads(lines[-1])["launches"], lines[:-1]


def train_child(argv: list) -> int:
    """``chip_smoke.py --train-child ARGS``: launch.train's main on ARGS with
    the parent's matmul settings, every plain version barred unless ARGS
    ask for the CPU; the launch counts as the last line's JSON."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.launch import train as launch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    on_cpu = "--device" in argv and argv[argv.index("--device") + 1] == "cpu"
    kernels.reset_launch_counts()
    with contextlib.nullcontext() if on_cpu else plain_versions_barred():
        launch.main(argv)
    print(json.dumps({"launches": kernels.launch_counts()}))
    return 0


def mamba_train_args(m: int, dev: str = "cuda") -> list:
    """The mamba2-370m trainer's flags at M = m workers: the global batch
    stays 4 sequences of 4,096 tokens. On the CPU (a rehearsal) the smoke
    config and 64 tokens."""
    where = (["--full", "--seq-len", str(TRAINER_SEQ_LEN)] if dev == "cuda"
             else ["--device", dev, "--seq-len", "64"])
    return ["--arch", "mamba2-370m", "--host-data", str(m), "--batch", "4", "--seed", "0",
            "--compressor", "sparsign", "--budget-kind", "l2_norm", "--budget", "0.1",
            "--server", "scaled_sign_ef", "--vote-impl", "allgather_packed"] + where


def reset_peak(torch) -> None:
    sync(torch)
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def phase_mamba_trainer(torch, report, totals, dev="cuda"):
    """mamba2-370m at full width through repro_torch.launch.train, M = 4 on
    the card, one 4,096-token sequence a worker, sparsign with the
    scaled-sign EF server on allgather_packed (the EF residual rides in the
    checkpoint). Run A: 4 steps straight. Run B: a checkpoint every 2 steps,
    dying at step 3 by the injected RuntimeError. The restart: the launcher
    in a fresh process with B's flags but --fail-at, whose step-4
    checkpoint must hold A's parameters and EF residual bit for bit. Then
    the checkpoint resumed at M = 2 for 2 more steps. Checkpoints live in a temporary directory removed at the
    end. ``dev="cpu"`` rehearses it at the smoke size, where only the
    launch counts cannot hold."""
    import tempfile

    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import engine
    from repro_torch.core.compressors import tree_leaves
    from repro_torch.dist import collectives
    from repro_torch.launch import train as launch
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop

    m, steps = 4, 4
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mamba_")
    d = str(pathlib.Path(tmp) / "ckpt")
    try:
        # -- run A: 4 steps straight, counted with every plain version barred
        args = launch.parser().parse_args(mamba_train_args(m, dev) + ["--steps", str(steps)])
        reset_peak(torch)
        cfg, model, group, step, state, comp = launch.build_everything(args)
        leaves = len(tree_leaves(model.param_shapes()))
        sizes = [math.prod(sd.shape) for sd in tree_leaves(model.param_shapes())]
        ledger = float(np.float32(sum(collectives.uplink_ledger(
            step.mode, step.wire, n, share_linf=engine.needs_shared_linf(comp))
            for n in sizes)))
        per_step = dict(sparsign_pack2bit=leaves * m, unpack2bit_sum=leaves, ef_server=leaves)
        kernels.reset_launch_counts()
        with plain_versions_barred():
            state_a, history = loop.run(step, state, launch.batch_fn_for(cfg, args),
                                        loop.LoopConfig(total_steps=steps, log_every=1))
        sync(torch)
        counts = kernels.launch_counts()
        want = expected(**{k: v * steps for k, v in per_step.items()})
        check(counts == want, f"mamba2 run A: launches {counts}, expected {want}")
        for k in totals:
            totals[k] += counts[k]
        walls = [h["wall_s"] for h in history]
        step_s = [b - a for a, b in zip([0.0] + walls[:-1], walls)]
        for h in history:
            check(math.isfinite(h["loss"]), f"mamba2 run A: non-finite loss {h['loss']}")
            check(h["wire_bytes_per_device"] == ledger,
                  f"mamba2 run A: wire bytes {h['wire_bytes_per_device']} != ledger {ledger}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_params = sum(sizes)
        out["run_a"] = {"steps": steps, "step_s": step_s, "loss": [h["loss"] for h in history],
                        "nnz_frac": [h["nnz_frac"] for h in history],
                        "wire_bytes_per_device": ledger, "peak_gb": peak, "launches": counts,
                        "parameters": n_params, "leaves": leaves}
        print(f"[mamba2] run A: {cfg.n_layers} layers, {n_params} parameters, M = {m}, "
              f"{TRAINER_SEQ_LEN} tokens a worker: steps {[round(x, 3) for x in step_s]} s, "
              f"losses {[round(h['loss'], 6) for h in history]}, wire bytes a device "
              f"{ledger:.10g} (== the ledger), peak {peak:.2f} GB, launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        del step, state, model
        torch.cuda.empty_cache()

        # -- run B: a checkpoint every 2 steps, the injected failure at step 3
        lines, died = [], None
        argv_b = mamba_train_args(m, dev) + ["--steps", str(steps), "--ckpt-dir", d,
                                        "--ckpt-every", "2"]
        kernels.reset_launch_counts()
        with plain_versions_barred(), stdout_lines(lines):
            try:
                launch.main(argv_b + ["--fail-at", "3"])
            except RuntimeError as e:   # any other exception fails the phase
                died = str(e)
        check(died == "injected failure at step 3", f"mamba2 run B: died with {died!r}")
        counts = kernels.launch_counts()
        want = expected(**{k: v * 3 for k, v in per_step.items()})
        check(counts == want, f"mamba2 run B: launches {counts}, expected {want}")
        for k in totals:
            totals[k] += counts[k]
        check(ckpt.latest_steps(d) == [2], f"mamba2 run B: checkpoints {ckpt.latest_steps(d)}")
        gb = dir_gb(pathlib.Path(d) / "step_00000002")
        save_b = loop_seconds(lines, "saved")
        print(f"[mamba2] run B died as injected ({died}); checkpoint step 2: {gb:.3f} GB on "
              f"disk, saved in {save_b} s")
        torch.cuda.empty_cache()

        # -- the restart: a fresh process (as after a lost one, and as JAX's
        # check_fault_tolerance.py restarts), B's flags without --fail-at;
        # its step-4 checkpoint, restored here, must equal run A's state
        t0 = time.perf_counter()
        counts, lines = train_in_child(argv_b)
        restart_s = time.perf_counter() - t0
        want = expected(**{k: v * 2 for k, v in per_step.items()})
        check(counts == want, f"mamba2 restart: launches {counts}, expected {want}")
        for k in totals:
            totals[k] += counts[k]
        check(any(line.startswith("[loop] resumed from step 2") for line in lines),
              f"mamba2 restart did not resume from step 2: {lines[:3]}")
        check(ckpt.latest_steps(d) == [2, 4], f"mamba2 restart: checkpoints "
                                              f"{ckpt.latest_steps(d)}")
        state_r, _ = ckpt.restore(d, state_a, step=steps)
        la = tree_leaves([state_a.params, state_a.ef_residual])
        lb = tree_leaves([state_r.params, state_r.ef_residual])
        check(len(la) == len(lb) == 2 * leaves and state_r.step == state_a.step == steps
              and state_r.seed == state_a.seed,
              f"mamba2 restart: {len(lb)} leaves at step {state_r.step}")
        differ = sum(int((bits(a) != bits(b)).sum()) for a, b in zip(la, lb))
        check(differ == 0, f"mamba2 restart: {differ} coordinates of the parameters and the EF "
                           f"residual differ from run A")
        del la, lb, state_a, state_r
        restore_r, save_r = loop_seconds(lines, "resumed"), loop_seconds(lines, "saved")
        print(f"[mamba2] restart ({restart_s:.1f} s, a fresh process): resumed at step 2 "
              f"in {restore_r} s, saved in {save_r} s; its step-4 checkpoint's parameters and "
              f"EF residual bit for bit equal to run A's ({2 * leaves} leaves)")
        torch.cuda.empty_cache()

        # -- the elastic restore: the step-4 checkpoint at M = 2, 2 more steps
        lines = []
        kernels.reset_launch_counts()
        reset_peak(torch)
        with plain_versions_barred(), stdout_lines(lines):
            state_e, hist_e = launch.main(mamba_train_args(2, dev) + [
                "--steps", "6", "--ckpt-dir", d, "--ckpt-every", "2"])
        counts = kernels.launch_counts()
        want = expected(sparsign_pack2bit=leaves * 2 * 2, unpack2bit_sum=leaves * 2,
                        ef_server=leaves * 2)
        check(counts == want, f"mamba2 elastic: launches {counts}, expected {want}")
        for k in totals:
            totals[k] += counts[k]
        check(state_e.step == 6 and all(math.isfinite(h["loss"]) for h in hist_e)
              and hist_e[-1]["participated"] == 2.0,
              f"mamba2 elastic: step {state_e.step}, history {hist_e}")
        restore_e = loop_seconds(lines, "resumed")
        check(any(line.startswith("[loop] resumed from step 4") for line in lines),
              "mamba2 elastic: did not resume from step 4")
        out.update(run_b={"died": died, "ckpt_gb": gb, "save_s": save_b},
                   restart={"run_s": restart_s, "restore_s": restore_r, "save_s": save_r,
                            "differ": differ},
                   elastic={"workers": 2, "step": state_e.step, "restore_s": restore_e,
                            "save_s": loop_seconds(lines, "saved"),
                            "loss": [h["loss"] for h in hist_e],
                            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                            "launches": counts})
        print(f"[mamba2] elastic: the step-4 checkpoint resumed at M = 2 in {restore_e} s, "
              f"step {state_e.step}, loss {hist_e[-1]['loss']:.6f}, saves "
              f"{out['elastic']['save_s']} s, peak {out['elastic']['peak_gb']:.2f} GB")
        del state_e
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    report["mamba_trainer"] = out


MAMBA_SERVE_ARGS = ["--arch", "mamba2-370m"] + SERVE_ARGS[2:]
# decode after a prefill against forward_hidden's last logits, mamba2-370m
# at full width with random weights: max |difference| over max |logit|.
# Measured 0.0167 in bf16 and 7.98e-4 in float32 on "NVIDIA H100 80GB HBM3,
# 700.00 W" (PERF.md); the bounds leave 6x and 5x. With every float32 cast
# made float64, decode equals the chunked forward to 3e-13 at full width
# (tests/test_torch_mamba.py holds 1e-12 at smoke size): the gap is rounding
# through 48 layers.
MAMBA_DECODE_REL_TOL = 0.1
MAMBA_DECODE_F32_REL_TOL = 4e-3


def phase_mamba_serve(torch, report, totals, dev="cuda"):
    """Serving mamba2-370m at full width: the launcher's loop with its 2-bit
    update rounds (counted, plain versions barred), a timed 4 x 2048
    prefill, and decode after a prefill against the full forward in bf16
    and once in float32. ``dev="cpu"`` rehearses it at the smoke size and a
    4 x 160 prefill, where only the launch counts cannot hold."""
    from repro_torch import kernels
    from repro_torch.configs.registry import get_config
    from repro_torch.core.compressors import tree_leaves
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.model import Model
    from repro_torch.serve.decode import build_prefill

    on_card, out = dev == "cuda", {}
    serve_args = (MAMBA_SERVE_ARGS if on_card
                  else [a for a in MAMBA_SERVE_ARGS if a != "--full"] + ["--device", dev])
    prefill_len = PREFILL_LEN if on_card else 160
    cfg = get_config("mamba2-370m", smoke=not on_card)
    leaves = len(tree_leaves(Model(cfg).param_shapes()))
    reset_peak(torch)
    kernels.reset_launch_counts()
    with plain_versions_barred():
        loop = launch_serve.main(serve_args)
    sync(torch)
    counts = kernels.launch_counts()
    rounds = loop["updates"]
    want = expected(pack2bit=leaves * rounds, unpack2bit=leaves * rounds,
                    vote_update=leaves * rounds)
    check(rounds == 4 and counts == want, f"mamba2 serve loop: {rounds} rounds, launches "
                                          f"{counts}, expected {want}")
    for k in totals:
        totals[k] += counts[k]
    out["loop"] = {**loop, "launches": counts,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[mamba2 serve] launch.serve {' '.join(serve_args)}: {loop['tokens']} tokens "
          f"in {loop['seconds']:.2f} s, decode {loop['decode_ms_median']:.2f} ms a token "
          f"(median of {loop['decode_steps']} steps), packed2bit ingest ms a round "
          f"{[round(x, 2) for x in loop['ingest_ms']]}, peak {out['loop']['peak_gb']:.2f} GB, "
          f"launches { {k: v for k, v in counts.items() if v} }")

    for dtype, tol in (("bfloat16", MAMBA_DECODE_REL_TOL), ("float32", MAMBA_DECODE_F32_REL_TOL)):
        model = Model(dataclasses.replace(cfg, dtype=dtype))
        params = model.init(0, dev)
        gen = torch.Generator(device=dev).manual_seed(5)
        toks = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, prefill_len), generator=gen,
                             device=dev, dtype=torch.int32)
        pos = torch.arange(prefill_len, device=dev, dtype=torch.int32).expand(PREFILL_BATCH, -1)
        prefill = build_prefill(model)
        batch = {"inputs": toks, "positions": pos}
        logits, caches = prefill(params, batch)
        del logits, caches
        sync(torch)
        t0 = time.perf_counter()
        logits, caches = prefill(params, batch)
        sync(torch)
        prefill_s = time.perf_counter() - t0
        check(tuple(logits.shape) == (PREFILL_BATCH, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()), f"mamba2 prefill ({dtype}): logits not "
                                                      f"finite or misshapen")
        del logits, caches
        s = 128
        rel, floor, agree = decode_vs_forward(torch, model, params, toks, pos, s)
        check(rel <= tol and agree >= 0.75,
              f"mamba2 decode after a {s}-token prefill ({dtype}): {rel:.3g} of max |logit| "
              f"from the full forward (tolerance {tol}), argmax agreeing for {agree:.0%}")
        ntok = PREFILL_BATCH * prefill_len
        out[dtype] = {"prefill_s": prefill_s, "prefill_tokens_per_s": ntok / prefill_s,
                      "decode_vs_forward": {"prompt": s, "rel_err": rel, "floor": floor,
                                            "argmax_agree": agree, "tol": tol}}
        print(f"[mamba2 serve] {dtype}: prefill {PREFILL_BATCH} x {prefill_len} tokens "
              f"{prefill_s * 1e3:.1f} ms ({ntok / prefill_s:.0f} tokens/s); decode after a "
              f"{s}-token prefill vs forward_hidden: max |diff| {rel:.4g} of max |logit| "
              f"(tolerance {tol}; a forward one token longer gives {floor:.4g}), argmax agrees "
              f"for {agree:.0%}")
        del params, model
        torch.cuda.empty_cache()
    report["mamba_serve"] = out


# the zoo's training runs: each at its published widths, to this many layers
# (at full depth qwen2.5-32b's, granite-34b's, qwen2-moe-a2.7b's and
# gemma3-27b's weights, 65.5, 94.5, 30.3 and 56.6 GB, leave no room to train
# M = 4 on one card; gemma3-27b's 8 are one 6-layer pattern and its 2-layer
# tail, hubert-xlarge's 48 its full depth)
ZOO_LAYERS = {"qwen2.5-32b": 2, "granite-34b": 2, "qwen2-moe-a2.7b": 2, "gemma3-27b": 8,
              "hubert-xlarge": 48}


def phase_zoo(torch, report, totals, dev="cuda"):
    """The simple-mode zoo through repro_torch.launch.train on the card, each
    at its published widths cut to ZOO_LAYERS[arch] layers: qwen2.5-32b (GQA
    40:8 at head_dim 128, QKV bias), granite-34b (MQA 48:1), qwen2-moe-a2.7b
    (60 routed experts of 64 padded, top 4, 4 shared), gemma3-27b (5:1
    windowed:global, window 1,024, the unstacked tail, tied embeddings) and
    hubert-xlarge (frame inputs, bidirectional attention, the GELU MLP):
    M = 4, one 4,096-token (or frame) sequence a worker, 2 steps of sparsign
    with majority vote on allgather_packed, launches counted with every
    plain version barred, wire bytes held to the ledger. ``dev="cpu"``
    rehearses it at the smoke size, where only the launch counts cannot
    hold."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core.compressors import tree_leaves
    from repro_torch.dist import collectives
    from repro_torch.launch import train as launch
    from repro_torch.train import loop

    m, steps, out = 4, 2, {}
    where = (["--full", "--seq-len", str(TRAINER_SEQ_LEN)] if dev == "cuda"
             else ["--device", dev, "--seq-len", "64"])
    get_config = launch.get_config

    def cut(arch, smoke):
        cfg = get_config(arch, smoke=smoke)
        return dataclasses.replace(cfg, n_layers=min(cfg.n_layers, ZOO_LAYERS[arch]))

    launch.get_config = cut
    try:
        for arch in ZOO_LAYERS:
            args = launch.parser().parse_args([
                "--arch", arch, "--host-data", str(m), "--batch", str(m), "--steps",
                str(steps), "--seed", "0", "--compressor", "sparsign", "--budget-kind",
                "l2_norm", "--budget", "0.1", "--server", "majority_vote", "--vote-impl",
                "allgather_packed"] + where)
            reset_peak(torch)
            cfg, model, group, step, state, comp = launch.build_everything(args)
            sizes = [math.prod(sd.shape) for sd in tree_leaves(model.param_shapes())]
            leaves = len(sizes)
            ledger = float(np.float32(sum(collectives.uplink_ledger(step.mode, step.wire, n)
                                          for n in sizes)))
            kernels.reset_launch_counts()
            with plain_versions_barred():
                state, history = loop.run(step, state, launch.batch_fn_for(cfg, args),
                                          loop.LoopConfig(total_steps=steps, log_every=1),
                                          log=lambda line: None)
            sync(torch)
            counts = kernels.launch_counts()
            want = expected(sparsign_pack2bit=leaves * m * steps, unpack2bit_sum=leaves * steps,
                            vote_update=leaves * steps)
            check(counts == want, f"{cfg.name}: launches {counts}, expected {want}")
            for k in totals:
                totals[k] += counts[k]
            check(all(math.isfinite(h["loss"]) and h["wire_bytes_per_device"] == ledger
                      for h in history), f"{cfg.name}: {history}")
            check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params)),
                  f"{cfg.name}: non-finite parameters")
            walls = [h["wall_s"] for h in history]
            step_s = [b - a for a, b in zip([0.0] + walls[:-1], walls)]
            peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else 0.0
            out[arch] = {"layers": cfg.n_layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
                         "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                         "d_ff": cfg.moe_d_ff if cfg.n_experts else cfg.d_ff,
                         "vocab": cfg.vocab_size, "parameters": sum(sizes),
                         "leaves": leaves, "tokens_per_worker": args.seq_len,
                         "step_s": step_s, "loss": [h["loss"] for h in history],
                         "wire_bytes_per_device": ledger, "peak_gb": peak, "launches": counts}
            print(f"[zoo] {cfg.name}, {cfg.n_layers} layers at d_model {cfg.d_model} "
                  f"({cfg.n_heads}:{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
                  f"{out[arch]['d_ff']}"
                  + (f" a routed expert, {cfg.n_experts} experts top {cfg.top_k}"
                     if cfg.n_experts else "")
                  + f", vocab {cfg.vocab_size}; {sum(sizes)} parameters in {leaves} leaves), "
                  f"M = {m}, {args.seq_len} {'frames' if cfg.input_kind != 'tokens' else 'tokens'}"
                  f" a worker: steps {[round(x, 3) for x in step_s]} s, losses "
                  f"{[round(h['loss'], 6) for h in history]}, wire bytes {ledger:.10g} "
                  f"(== the ledger), peak {peak:.2f} GB, launches "
                  f"{ {k: v for k, v in counts.items() if v} }")
            del step, state, model
            if dev == "cuda":
                torch.cuda.empty_cache()
    finally:
        launch.get_config = get_config
    report["zoo"] = out


# the zoo served at full width and depth: the launcher's loop with a shorter
# prompt and generation than qwen1.5-4b's and no update rounds (the ingest's
# int32 vote temporaries of qwen2-moe-a2.7b's and qwen2.5-32b's largest
# leaves, 17.7 and 36 GB, would not fit beside their weights; the ingest is
# the same code for every model and is held on qwen1.5-4b and mamba2-370m)
ZOO_SERVE = ("qwen2.5-32b", "qwen2-moe-a2.7b", "gemma3-27b")
ZOO_SERVE_ARGS = ["--full", "--batch", "4", "--prompt-len", "32", "--tokens", "16",
                  "--seed", "0"]


def phase_zoo_serve(torch, report, totals, dev="cuda"):
    """Serving the zoo at full width and depth, one model on the card at a
    time: for qwen2.5-32b, qwen2-moe-a2.7b and gemma3-27b the launcher's
    loop (ZOO_SERVE_ARGS), a timed 4 x 2048 prefill, and decode of token
    2,048 after a 2,048-token prefill against the full forward within
    DECODE_REL_TOL (gemma3-27b's windowed layers decode from the 1,024-slot
    rings the prefill left, past their window); then hubert-xlarge's encoder
    probe (build_prefill: the full forward's loss, no caches) on 4 x 2048
    frames, which must be finite. ``dev="cpu"`` rehearses it at the smoke
    size with a 4 x 40 prefill and a 24-token decode check (past the smoke
    window of 8)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.model import Model
    from repro_torch.serve.decode import build_prefill

    on_card, out = dev == "cuda", {}
    prefill_len = PREFILL_LEN if on_card else 40
    s = PREFILL_LEN if on_card else 24

    def timed(fn):
        """(fn(), its host seconds to a sync)."""
        sync(torch)
        t0 = time.perf_counter()
        res = fn()
        sync(torch)
        return res, time.perf_counter() - t0

    for arch in ZOO_SERVE:
        serve_args = (["--arch", arch] + ZOO_SERVE_ARGS if on_card else
                      ["--arch", arch] + [a for a in ZOO_SERVE_ARGS if a != "--full"]
                      + ["--device", dev])
        reset_peak(torch)
        loop = launch_serve.main(serve_args)
        sync(torch)
        loop_peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
        cfg = get_config(arch, smoke=not on_card)
        model = Model(cfg)
        t0 = time.perf_counter()
        params = model.init(0, dev)
        sync(torch)
        init_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(5)
        toks = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, max(prefill_len, s + 2)),
                             generator=gen, device=dev, dtype=torch.int32)
        pos = torch.arange(toks.shape[1], device=dev, dtype=torch.int32).expand(
            PREFILL_BATCH, -1)
        # decode against the forward first: its prefill, of the timed one's
        # shape on the card, is the timed one's warm-up
        rel, _, agree = decode_vs_forward(torch, model, params, toks, pos, s, floor=False)
        check(rel <= DECODE_REL_TOL, f"{arch} decode after a {s}-token prefill: {rel:.3g} of "
                                     f"max |logit| from the full forward (tolerance "
                                     f"{DECODE_REL_TOL})")
        prefill = build_prefill(model)
        batch = {"inputs": toks[:, :prefill_len], "positions": pos[:, :prefill_len]}
        reset_peak(torch)
        (logits, caches), prefill_s = timed(lambda: prefill(params, batch))
        check(tuple(logits.shape) == (PREFILL_BATCH, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()), f"{arch} prefill: logits not finite or "
                                                      f"misshapen")
        rings = sorted({c["k"].shape[1] for c in caches})
        del logits, caches
        prefill_peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
        windows = sorted({spec.window for spec in cfg.pattern + cfg.tail_pattern
                          if spec.window is not None})
        check(all(w < s for w in windows), f"{arch}: the decode check stops inside a window")
        ntok = PREFILL_BATCH * prefill_len
        out[arch] = {"loop": {**loop, "peak_gb": loop_peak}, "init_s": init_s,
                     "prefill": {"batch": PREFILL_BATCH, "tokens": prefill_len,
                                 "seconds": prefill_s, "tokens_per_s": ntok / prefill_s,
                                 "peak_gb": prefill_peak, "cache_depths": rings},
                     "decode_vs_forward": {"prompt": s, "rel_err": rel, "argmax_agree": agree,
                                           "tol": DECODE_REL_TOL, "windows": windows}}
        print(f"[zoo serve] {cfg.name} ({cfg.n_layers} layers, {model.param_count()} "
              f"parameters, init {init_s:.1f} s): launch.serve {' '.join(serve_args)}: decode "
              f"{loop['decode_ms_median']:.2f} ms a token (median of {loop['decode_steps']} "
              f"steps), peak {loop_peak:.2f} GB; prefill {PREFILL_BATCH} x {prefill_len} tokens "
              f"{prefill_s * 1e3:.1f} ms ({ntok / prefill_s:.0f} tokens/s, cache depths "
              f"{rings}), peak {prefill_peak:.2f} GB; decode of token {s} after a {s}-token "
              f"prefill vs forward_hidden: max |diff| {rel:.4g} of max |logit| (tolerance "
              f"{DECODE_REL_TOL}), argmax agrees for {agree:.0%}"
              + (f"; windows {windows} crossed" if windows else ""))
        del params, model, prefill, batch, toks, pos
        if on_card:
            torch.cuda.empty_cache()

    cfg = get_config("hubert-xlarge", smoke=not on_card)
    model = Model(cfg)
    params = model.init(0, dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    frames = torch.randn((PREFILL_BATCH, prefill_len, cfg.d_model), generator=gen,
                         device=dev) * 0.3
    labels = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, prefill_len), generator=gen,
                           device=dev, dtype=torch.int32)
    pos = torch.arange(prefill_len, device=dev, dtype=torch.int32).expand(PREFILL_BATCH, -1)
    probe = build_prefill(model)
    batch = {"inputs": frames, "labels": labels, "positions": pos}
    probe(params, batch)   # warm-up
    reset_peak(torch)
    loss, probe_s = timed(lambda: probe(params, batch))
    check(loss.shape == () and bool(torch.isfinite(loss)), f"hubert-xlarge probe: {loss}")
    nfr = PREFILL_BATCH * prefill_len
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    out["hubert-xlarge"] = {"probe": {"batch": PREFILL_BATCH, "frames": prefill_len,
                                      "loss": float(loss), "seconds": probe_s,
                                      "frames_per_s": nfr / probe_s, "peak_gb": peak}}
    print(f"[zoo serve] {cfg.name} encoder probe ({cfg.n_layers} layers): "
          f"{PREFILL_BATCH} x {prefill_len} frames, loss {float(loss):.6f} (finite), "
          f"{probe_s * 1e3:.1f} ms ({nfr / probe_s:.0f} frames/s), peak {peak:.2f} GB")
    del params, model
    if on_card:
        torch.cuda.empty_cache()
    report["zoo_serve"] = out


# the streamed phase's depths: S1's 8 of llama4-scout's 48 layers (19.7 B
# parameters, 39.4 GB in bf16: the simple trainer would hold one worker's
# gradient beside them, 78.8 GB), S2's 2 (6.47 B: all three steps fit), and
# S3's 8 of qwen2-vl-72b's 80 (8.27 B)
STREAMED_LAYERS = (8, 2, 8)
STREAMED_STEPS = 1   # S1's and S3's steps through the launcher
STREAMED_ARCHS = ("llama4-scout-17b-a16e", "qwen2-vl-72b")
# S2's fixed sparsign budget B (a coordinate votes w.p. min(|g| B, 1)): at
# B = 1e-3 the card read a density of 1.6e-7, so B = 300 aims at about 5 %
S2_BUDGET = 300.0
DIGEST_CHUNK = 1 << 26


def bit_digest(torch, t) -> tuple:
    """Two int64 sums of a tensor's bits, in chunks (no full-size int64
    copy): the plain sum and the sum weighted by (index mod 65521) + 1. Equal
    tensors give equal digests; a changed coordinate moves both."""
    flat = t.reshape(-1)
    view = flat.view(torch.int16 if flat.element_size() == 2 else torch.int32)
    a = b = 0
    for i in range(0, view.numel(), DIGEST_CHUNK):
        v = view[i:i + DIGEST_CHUNK].to(torch.int64)
        w = (torch.arange(i, i + v.numel(), device=v.device, dtype=torch.int64) % 65521) + 1
        a += int(v.sum())
        b += int((v * w).sum())
    return a, b


def phase_streamed(torch, report, totals, dev="cuda"):
    """The streamed (FSDP) trainer on one card, M = 4 in one process,
    TRAINER_SEQ_LEN tokens (frames) a worker, launches counted with every
    plain version barred: S1 trains llama4-scout-17b-a16e at its published
    widths cut to STREAMED_LAYERS[0] layers through the launcher's loop; S2
    holds the streamed step (per leaf, repeated, bucketed) and the simple
    step bit for bit at STREAMED_LAYERS[1] layers and the EF server per leaf
    against bucketed; S3 trains qwen2-vl-72b cut to STREAMED_LAYERS[2]
    layers and serves it. Under a 'model' axis of TP_T: S1T trains S1's cut
    through the launcher, S2T holds injected rounds at S2's depth against
    T = 1 (``tp_streamed_injected``). ``dev="cpu"`` rehearses it at the smoke
    sizes, where only the launch counts cannot hold."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.analysis.drivers import tp_slice_ledger
    from repro_torch.core.algorithm import CompressionConfig
    from repro_torch.core.budgets import BudgetConfig
    from repro_torch.core.compressors import tree_leaves, tree_unflatten
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch
    from repro_torch.models.model import Model
    from repro_torch.serve.decode import build_prefill
    from repro_torch.train import loop
    from repro_torch.train.state import LrSchedule, init_state
    from repro_torch.train.step_simple import TrainStepConfig, build_train_step
    from repro_torch.train.step_streamed import (StreamedStepConfig, build_streamed_train_step,
                                                 shard_state)

    on_card, m, out = dev == "cuda", 4, {}
    seq = TRAINER_SEQ_LEN if on_card else 64
    where = (["--full", "--seq-len", str(seq)] if on_card else ["--device", dev, "--seq-len",
                                                               str(seq)])
    get_config = launch.get_config
    serve_get_config = launch_serve.get_config
    depth = {}

    def cut(arch, smoke):
        cfg = get_config(arch, smoke=smoke)
        return dataclasses.replace(cfg, n_layers=min(cfg.n_layers, depth[arch]))

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0

    def counted(fn):
        """fn() with the launch counts zeroed before and read after, every
        plain version barred; the counts go to the phase's totals."""
        kernels.reset_launch_counts()
        with plain_versions_barred():
            res = fn()
        sync(torch)
        counts = kernels.launch_counts()
        for k in totals:
            totals[k] += counts[k]
        return res, counts

    def train_args(arch, steps, t=1):
        return launch.parser().parse_args([
            "--arch", arch, "--host-data", str(m), "--host-model", str(t), "--batch", str(m),
            "--steps", str(steps), "--seed", "0", "--compressor", "sparsign", "--budget-kind",
            "l2_norm", "--budget", "0.1", "--server", "majority_vote", "--vote-impl",
            "allgather_packed"] + where)

    def run_loop(arch, steps, label, t=1):
        """The launcher's build and loop at a 'model' axis of ``t``: (cfg,
        model, step, state, numbers)."""
        args = train_args(arch, steps, t)
        reset_peak(torch)
        cfg, model, group, step, state, comp = launch.build_everything(args)
        init_peak = peak_gb()
        reset_peak(torch)
        batch_fn, draw_s = launch.batch_fn_for(cfg, args), []

        def timed_batch(i):   # the host's draw of the batch, inside the loop's wall
            t0 = time.perf_counter()
            b = batch_fn(i)
            draw_s.append(time.perf_counter() - t0)
            return b

        (state, history), counts = counted(lambda: loop.run(
            step, state, timed_batch,
            loop.LoopConfig(total_steps=steps, log_every=1), log=lambda line: None))
        train_peak = peak_gb()
        peak = max(init_peak, train_peak)
        walls = [h["wall_s"] for h in history]
        step_s = [b - a for a, b in zip([0.0] + walls[:-1], walls)]
        ledger = float(np.float32(tp_slice_ledger(step, model)))
        check(ledger == float(np.float32(step.ledger[0])),
              f"{label}: the slice ledger {ledger} against the step's {step.ledger[0]}")
        check(all(math.isfinite(h["loss"]) and h["wire_bytes_per_device"] == ledger
                  for h in history), f"{label}: {history}")
        check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params)),
              f"{label}: non-finite parameters")
        n_blk = len(tree_leaves(model.param_shapes()["blocks"]))
        per_step = cfg.n_repeats * n_blk + len(tree_leaves(model.param_shapes())) - n_blk
        want = streamed_expected(step, "pack2", m, steps)
        check(counts == want, f"{label}: launches {counts}, expected {want}")
        res = {"config": cfg.name, "layers": cfg.n_layers, "parameters": model.param_count(),
               "leaves": len(tree_leaves(model.param_shapes())), "exchanges_a_step": per_step,
               "workers": m, "tokens_per_worker": seq, "step_s": step_s, "batch_draw_s": draw_s,
               "loss": [h["loss"] for h in history],
               "nnz_frac": [h["nnz_frac"] for h in history], "wire_bytes_per_device": ledger,
               "peak_gb": peak, "init_peak_gb": init_peak, "train_peak_gb": train_peak,
               "launches": {k: v for k, v in counts.items() if v},
               "map_launches": {k: v for k, v in kernels.map_launch_counts().items() if v}}
        return cfg, model, step, state, res

    try:
        launch.get_config = cut
        launch_serve.get_config = cut
        # -- S1: llama4-scout, 8 layers at its published widths ------------
        arch = STREAMED_ARCHS[0]
        depth[arch] = STREAMED_LAYERS[0]
        cfg, model, step, state, s1 = run_loop(arch, STREAMED_STEPS, "S1")
        weights_gb = model.param_count() * 2 / 1e9
        s1["simple_need_gb"] = 2 * weights_gb
        print(f"[streamed S1] {cfg.name}, {cfg.n_layers} of 48 layers at d_model {cfg.d_model} "
              f"({cfg.n_heads}:{cfg.n_kv_heads} heads, {cfg.n_experts} experts top "
              f"{cfg.top_k} of d_ff {cfg.moe_d_ff} + {cfg.n_shared_experts} shared, vocab "
              f"{cfg.vocab_size}; {s1['parameters']} parameters in {s1['leaves']} leaves), "
              f"M = {m}, {seq} tokens a worker, per leaf: steps "
              f"{[round(x, 3) for x in s1['step_s']]} s, losses "
              f"{[round(x, 6) for x in s1['loss']]}, nnz_frac "
              f"{[float(f'{x:.4g}') for x in s1['nnz_frac']]}, wire bytes "
              f"{s1['wire_bytes_per_device']:.10g}"
              f" (== the streamed ledger), peak {s1['peak_gb']:.2f} GB against the simple "
              f"trainer's {s1['simple_need_gb']:.1f} GB of weights and one worker's gradient, "
              f"launches { {k: v for k, v in s1['launches'].items() if v} }")
        out["S1"] = s1
        del step, state, model
        if on_card:
            torch.cuda.empty_cache()
        # -- S1T: the same cut under a 'model' axis of TP_T ----------------
        cfg, model, step, state, s1t = run_loop(arch, STREAMED_STEPS, "S1T", t=TP_T)
        tp_streamed_line("S1T", s1t, s1)
        out["S1T"] = s1t
        del step, state, model
        if on_card:
            torch.cuda.empty_cache()

        # -- S2: the same model at 2 layers, three steps bit for bit -------
        depth[arch] = STREAMED_LAYERS[1]
        cfg = cut(arch, smoke=not on_card)
        model = Model(cfg)
        group = launch.make_host_mesh(m)
        args = train_args(arch, 1)
        batch = launch.batch_fn_for(cfg, args)(0)
        lr = LrSchedule(base=args.lr, warmup=args.warmup)
        # a fixed budget: an L2-norm budget reads the whole leaf, which the
        # streamed step takes a layer at a time and the simple step stacked
        comp = CompressionConfig(compressor="sparsign", budget=BudgetConfig(
            kind="fixed", value=S2_BUDGET), server="majority_vote")
        t0 = time.perf_counter()
        pristine = model.init(0, dev)
        sync(torch)
        init_s = time.perf_counter() - t0

        def one_step(build, label, comp_=comp, steps=1, params=None):
            """``steps`` steps from a clone of the pristine parameters (or
            from ``params``): (state, numbers)."""
            reset_peak(torch)
            step = build(comp_)
            if params is None:
                params = tree_unflatten(pristine, [t.clone() for t in tree_leaves(pristine)])
            state = init_state(params, server=comp_.server, seed=0)
            del params
            if hasattr(step, "layout"):
                state = shard_state(state, step.layout)
            times = []

            def go():
                nonlocal state
                for r in range(steps):
                    t1 = time.perf_counter()
                    state, met = step(state, batch if r == 0 else
                                      launch.batch_fn_for(cfg, args)(r))
                    sync(torch)
                    times.append(time.perf_counter() - t1)
                return met

            met, counts = counted(go)
            return state, {"step_s": times, "loss": float(met["loss"]), "peak_gb": peak_gb(),
                           "nnz_frac": float(met["nnz_frac"]),
                           "launches": counts,
                           "wire_bytes_per_device": float(met["wire_bytes_per_device"])}

        def streamed(bucketed, impl="allgather_packed"):
            return lambda c: build_streamed_train_step(model, StreamedStepConfig(
                compression=c, lr=lr, vote_impl=impl, bucketed=bucketed), group)

        def simple(c):
            return build_train_step(model, TrainStepConfig(
                compression=c, lr=lr, vote_impl="allgather_packed"), group)

        ref, s2 = None, {"layers": cfg.n_layers, "parameters": model.param_count(),
                         "init_s": init_s}
        for label, build in (("per_leaf", streamed(False)), ("repeat", streamed(False)),
                             ("bucketed", streamed(True)), ("simple", simple)):
            state, res = one_step(build, label)
            leaves = tree_leaves(state.params)
            if ref is None:
                ref = leaves
                res["differ"] = 0
            else:
                res["differ"] = sum(int((a.view(torch.int16) != b.view(torch.int16)).sum())
                                    if a.dtype == torch.bfloat16 else
                                    int((a.view(torch.int32) != b.view(torch.int32)).sum())
                                    for a, b in zip(leaves, ref))
                del leaves
            s2[label] = res
            del state
            if on_card:
                torch.cuda.empty_cache()
        del ref
        n_blk = len(tree_leaves(model.param_shapes()["blocks"]))
        per_step = cfg.n_repeats * n_blk + len(tree_leaves(model.param_shapes())) - n_blk
        n_leaves = len(tree_leaves(model.param_shapes()))
        for label, want in (
                ("per_leaf", expected(sparsign_pack2bit=m * per_step, unpack2bit_sum=per_step,
                                      vote_update=per_step)),
                ("repeat", expected(sparsign_pack2bit=m * per_step, unpack2bit_sum=per_step,
                                    vote_update=per_step)),
                ("bucketed", expected(sparsign_pack2bit=m * per_step,
                                      unpack2bit_sum=cfg.n_repeats + 2, vote_update=per_step)),
                ("simple", expected(sparsign_pack2bit=m * n_leaves, unpack2bit_sum=n_leaves,
                                    vote_update=n_leaves))):
            check(s2[label]["launches"] == want,
                  f"S2 {label}: launches {s2[label]['launches']}, expected {want}")
        differ = {k: s2[k]["differ"] for k in ("repeat", "bucketed", "simple")}
        check(not any(differ.values()),
              f"S2: coordinates that differ from the per-leaf streamed step {differ} "
              f"(repeat: the card's nondeterminism; bucketed: the double-buffered schedule; "
              f"simple: the per-layer exchange)")
        s2["ledgers"] = {k: s2[k]["wire_bytes_per_device"] for k in s2 if isinstance(s2[k], dict)
                         and "wire_bytes_per_device" in s2[k]}

        # the EF server on psum, 2 steps per leaf against bucketed (digests;
        # the float32 residual leaves no room for a pristine copy: the
        # parameters are drawn again from the seed)
        del pristine
        if on_card:
            torch.cuda.empty_cache()
        ef_comp = dataclasses.replace(comp, server="scaled_sign_ef")
        digests = []
        for label, build in (("ef_per_leaf", streamed(False, "psum")),
                             ("ef_bucketed", streamed(True, "psum"))):
            state, res = one_step(build, label, ef_comp, steps=2, params=model.init(0, dev))
            ef_ok = all(bool(torch.isfinite(e).all()) for e in tree_leaves(state.ef_residual))
            check(ef_ok, f"S2 {label}: non-finite EF residual")
            digests.append([bit_digest(torch, t) for t in tree_leaves(state.params)
                            + tree_leaves(state.ef_residual)])
            res["ef_finite"] = ef_ok
            s2[label] = res
            del state
            if on_card:
                torch.cuda.empty_cache()
        check(s2["ef_per_leaf"]["launches"]["ef_server"] == 2 * per_step,
              f"S2 EF: launches {s2['ef_per_leaf']['launches']}")
        s2["ef_digests_equal"] = digests[0] == digests[1]
        check(s2["ef_digests_equal"], "S2 EF: bucketed differs from per leaf (bit digests)")
        print(f"[streamed S2] {cfg.name} at {cfg.n_layers} layers ({s2['parameters']} "
              f"parameters, init {init_s:.1f} s): one step each, seconds, peak GB and "
              f"coordinates that differ from the per-leaf streamed step: "
              + "; ".join(f"{k} {[round(x, 3) for x in s2[k]['step_s']]} s, "
                          f"{s2[k]['peak_gb']:.2f} GB, {s2[k]['differ']} differ"
                          for k in ("per_leaf", "repeat", "bucketed", "simple"))
              + f"; nnz_frac {s2['per_leaf']['nnz_frac']:.4g} at a fixed budget of "
              f"{S2_BUDGET}; wire bytes per leaf {s2['per_leaf']['wire_bytes_per_device']:.10g}, "
              f"bucketed {s2['bucketed']['wire_bytes_per_device']:.10g}, simple "
              f"{s2['simple']['wire_bytes_per_device']:.10g}; scaled_sign_ef on psum 2 steps, "
              f"per leaf {[round(x, 3) for x in s2['ef_per_leaf']['step_s']]} s against "
              f"bucketed {[round(x, 3) for x in s2['ef_bucketed']['step_s']]} s: bit digests "
              f"equal, residual finite, peak {s2['ef_per_leaf']['peak_gb']:.2f} GB")
        out["S2"] = s2
        del model
        if on_card:
            torch.cuda.empty_cache()
        # -- S2T: injected gradients at T = TP_T against T = 1 -------------
        out["S2T"] = tp_streamed_injected(torch, totals, m, cfg, dev)

        # -- S3: qwen2-vl-72b, 8 layers: train, then serve -----------------
        arch = STREAMED_ARCHS[1]
        depth[arch] = STREAMED_LAYERS[2]
        cfg, model, step, state, s3 = run_loop(arch, STREAMED_STEPS, "S3")
        params = state.params
        del step, state
        serve_args = (["--arch", arch] + ZOO_SERVE_ARGS if on_card else
                      ["--arch", arch] + [a for a in ZOO_SERVE_ARGS if a != "--full"]
                      + ["--device", dev])
        reset_peak(torch)
        serve_loop = launch_serve.main(serve_args)
        sync(torch)
        s3["serve_loop"] = {**serve_loop, "peak_gb": peak_gb()}
        prefill_len = PREFILL_LEN if on_card else 40
        s = PREFILL_LEN if on_card else 24
        gen = torch.Generator(device=dev).manual_seed(5)
        frames = (torch.randn((PREFILL_BATCH, max(prefill_len, s + 2), cfg.d_model),
                              generator=gen, device=dev) * 0.3).to(cfg.activation_dtype)
        pos = torch.arange(frames.shape[1], device=dev, dtype=torch.int32).expand(
            PREFILL_BATCH, -1)
        rel, _, agree = decode_vs_forward(torch, model, params, frames, pos, s, floor=False)
        check(rel <= DECODE_REL_TOL, f"S3 decode after a {s}-frame prefill: {rel:.3g} of max "
                                     f"|logit| from the full forward (tolerance "
                                     f"{DECODE_REL_TOL})")
        prefill = build_prefill(model)
        pbatch = {"inputs": frames[:, :prefill_len], "positions": pos[:, :prefill_len],
                  "positions3": pos[:, :prefill_len, None].expand(-1, -1, 3)}
        reset_peak(torch)
        sync(torch)
        t0 = time.perf_counter()
        logits, caches = prefill(params, pbatch)
        sync(torch)
        prefill_s = time.perf_counter() - t0
        check(tuple(logits.shape) == (PREFILL_BATCH, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()), "S3 prefill: logits not finite or "
                                                      "misshapen")
        del logits, caches
        s3["prefill"] = {"batch": PREFILL_BATCH, "frames": prefill_len, "seconds": prefill_s,
                         "frames_per_s": PREFILL_BATCH * prefill_len / prefill_s,
                         "peak_gb": peak_gb()}
        s3["decode_vs_forward"] = {"prompt": s, "rel_err": rel, "argmax_agree": agree,
                                   "tol": DECODE_REL_TOL}
        print(f"[streamed S3] {cfg.name}, {cfg.n_layers} of 80 layers at d_model "
              f"{cfg.d_model} ({cfg.n_heads}:{cfg.n_kv_heads} heads, QKV bias, M-RoPE "
              f"{cfg.mrope_sections}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
              f"{s3['parameters']} parameters), M = {m}, {seq} frames a worker: steps "
              f"{[round(x, 3) for x in s3['step_s']]} s (of which the host's draw of the "
              f"frames {[round(x, 3) for x in s3['batch_draw_s']]} s), nnz_frac "
              f"{[float(f'{x:.4g}') for x in s3['nnz_frac']]}, losses "
              f"{[round(x, 6) for x in s3['loss']]}, wire bytes "
              f"{s3['wire_bytes_per_device']:.10g} (== the streamed ledger), peak "
              f"{s3['peak_gb']:.2f} GB, launches "
              f"{ {k: v for k, v in s3['launches'].items() if v} }; launch.serve "
              f"{' '.join(serve_args)}: decode {serve_loop['decode_ms_median']:.2f} ms a token, "
              f"peak {s3['serve_loop']['peak_gb']:.2f} GB; prefill {PREFILL_BATCH} x "
              f"{prefill_len} frames of the trained weights {prefill_s * 1e3:.1f} ms; decode "
              f"of position {s} after a {s}-frame prefill vs forward_hidden: max |diff| "
              f"{rel:.4g} of max |logit| (tolerance {DECODE_REL_TOL}), argmax agrees for "
              f"{agree:.0%}")
        out["S3"] = s3
        del params, model, prefill, frames, pos
        if on_card:
            torch.cuda.empty_cache()
    finally:
        launch.get_config = get_config
        launch_serve.get_config = serve_get_config
    report["streamed"] = out


# ---------------------------------------------------------------------------
# [tp streamed]: the streamed trainer under the 'model' axis (TP_T ranks)
# ---------------------------------------------------------------------------

#: S2T's fixed sparsign budget on the injected gradients (values in [-1/2,
#: 1/2): about half the coordinates vote), its Golomb target and the plan
#: fraction of a layer's coded message (above the target: a layer's message
#: truncates where its realized density outruns the plan)
TP_STREAMED_BUDGET = 2.0
TP_STREAMED_TARGET = 0.05
TP_STREAMED_GOLOMB_P = 0.06


def injected_streamed_net(torch, model):
    """``model``'s shapes, logical axes and placements with stages whose
    backward injects each leaf's gradient: frac(997 p + s) - 1/2 of the
    leaf's own values p and a scalar s of the incoming cotangent, exactly
    rounded operations a coordinate, so a model slice's gradient is the
    slice of the whole leaf's and T = 2 meets T = 1 bit for bit wherever
    the round itself does. ``h`` passes through every block; the head's
    loss is mean(h^2) and hands h the cotangent h / 64. The net is its own
    ``tensor_parallel`` (with the placements ``step_tp`` reads), and its
    ``loss`` runs the stages over every repeat, for the simple steps."""
    from repro_torch.core.compressors import tree_leaves, tree_unflatten
    from repro_torch.models import tensor_parallel as tpl
    from repro_torch.models.common import rms_norm

    def frac_grad(p, s):
        x = p.to(torch.float32) * 997.0 + s
        return (x - torch.floor(x) - 0.5).to(p.dtype)

    class Inject(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, *leaves):
            ctx.save_for_backward(*leaves)
            return h.clone()

        @staticmethod
        def backward(ctx, g):
            s = torch.sum(g.to(torch.float32) ** 2)
            return (g,) + tuple(frac_grad(p, s) for p in ctx.saved_tensors)

    class InjectHead(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, *leaves):
            loss = torch.mean(h.to(torch.float32) ** 2)
            ctx.save_for_backward(h, loss, *leaves)
            return loss

        @staticmethod
        def backward(ctx, g):
            h, loss, *leaves = ctx.saved_tensors
            return (h * (g / 64.0).to(h.dtype),) + tuple(frac_grad(p, loss) for p in leaves)

    def tensors(tree):
        return [y for x in tree_leaves(tree) for y in (x if isinstance(x, (list, tuple))
                                                       else [x])]

    class Net:
        def __init__(self, placements=None):
            self.model, self.cfg, self.placements = model, model.cfg, placements

        def param_shapes(self):
            return model.param_shapes()

        def param_logical_axes(self):
            return model.param_logical_axes()

        def init(self, seed, device=None):
            return model.init(seed, device)

        def tensor_parallel(self, mg):
            return Net(tpl.placements_for(model, mg.size))

        def embed_stage(self, params, batch):
            x = torch.as_tensor(batch["inputs"])
            if self.cfg.input_kind != "tokens":
                return x.to(self.cfg.activation_dtype)
            d = torch.arange(self.cfg.d_model, dtype=torch.float32, device=x.device)
            y = x.to(torch.float32)[..., None] * 0.618 + d * 0.37
            return Inject.apply((y - torch.floor(y) - 0.5).to(self.cfg.activation_dtype),
                                *tensors(params["embed"]))

        def superblock_apply(self, layer_slices, h, positions, positions3=None):
            return Inject.apply(h, *tensors(layer_slices))

        def head_loss(self, params, h, labels):
            return InjectHead.apply(h, *tensors([params[k] for k in sorted(params)
                                                 if k not in ("blocks", "embed")]))

        def loss(self, params, batch):
            """The stages over every repeat: a leaf the placement cuts is its
            stacked slices (the TP layout), layer l at [:, l]."""
            h = self.embed_stage(params, batch)
            pls = (tree_leaves(self.placements["blocks"]) if self.placements is not None
                   else None)
            blocks = tree_leaves(params["blocks"])
            for l in range(self.cfg.n_repeats):
                layer = tree_unflatten(params["blocks"], [
                    x[:, l] if pls is not None and pls[i].sharded else x[l]
                    for i, x in enumerate(blocks)])
                h = self.superblock_apply(layer, h, batch["positions"], batch.get("positions3"))
            loss = self.head_loss(params, rms_norm(h, params["final_norm"], self.cfg.norm_eps),
                                  batch["labels"])
            return loss, {"loss": loss}

    return Net()


def streamed_expected(step, kind: str, m: int, steps: int = 1) -> dict:
    """The launches of ``steps`` streamed steps (per leaf or bucketed) at M =
    ``m``: a message a worker of each layer's leaf (a slice a rank of a leaf
    cut on 'model') and of each outer leaf, one server launch a message's
    exchange, one decode an exchange (bucketed: a bucket a rank, each block
    bucket ``n_repeats + 1`` times). ``kind``: pack2, psum, golomb or ef
    (sparsign on psum with the EF server)."""
    from repro_torch.core.compressors import tree_leaves
    lay = step.layout
    outer = [lay[k] for k in sorted(lay) if k != "blocks"]
    blocks = tree_leaves(lay["blocks"])
    ranks = max([x.parts for x in blocks + outer if x.tp], default=1)

    def msgs(lays):
        return sum(x.parts if x.tp else 1 for x in lays)

    per = step.n_repeats * msgs(blocks) + msgs(outer)
    block_plan, outer_plan = step.plans
    decodes = per if block_plan is None else ranks * (
        (step.n_repeats + 1) * len(block_plan.buckets) + len(outer_plan.buckets))
    enc, dec, srv = {"pack2": ("sparsign_pack2bit", "unpack2bit_sum", "vote_update"),
                     "psum": ("sparsign", None, "vote_update"),
                     "golomb": ("sparsign_golomb", "ungolomb_sum", "vote_update"),
                     "ef": ("sparsign", None, "ef_server")}[kind]
    want = {enc: m * per * steps, srv: per * steps}
    if dec is not None:
        want[dec] = decodes * steps
    return expected(**want)


def tp_streamed_injected(torch, totals, m, cfg, dev="cuda") -> dict:
    """S2T: ``cfg`` (llama4-scout at STREAMED_LAYERS[1] layers) with injected
    gradients (``injected_streamed_net``), one step a run from one state, M =
    ``m``, every plain version barred: the streamed step at T = TP_T against
    T = 1 on the 2-bit gather bit for bit (chunked bit digests) with fixed
    sparsign on psum and on the 2-bit gather, bucketed in one bucket and in
    TP_BUCKET_BYTES, and the simple T = TP_T step (``step_tp``, the stages
    over both repeats); ``sparsign_golomb`` under ``target_sparsity`` within
    TP_FLIP_BOUND of T = 1 beyond float noise with nothing dropped;
    ``scaled_sign_ef`` on psum to rtol 1e-6 of T = 1 (bf16 weights: within
    float noise) with the same coordinates moving. Launches, seconds, peaks and wire bytes (== the
    slice ledger) a run."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.analysis.drivers import tp_slice_ledger
    from repro_torch.core.algorithm import CompressionConfig
    from repro_torch.core.budgets import BudgetConfig
    from repro_torch.core.compressors import tree_leaves, tree_unflatten
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.train.state import LrSchedule, init_state
    from repro_torch.train.step_simple import TrainStepConfig, build_train_step
    from repro_torch.train.step_streamed import StreamedStepConfig, build_streamed_train_step

    on_card = dev == "cuda"
    net = injected_streamed_net(torch, Model(cfg))
    seq = TRAINER_SEQ_LEN if on_card else 64
    batch = lm_batch(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=m,
                                    seed=0), 0)
    lr = LrSchedule(base=0.05)
    fixed = CompressionConfig(compressor="sparsign",
                              budget=BudgetConfig(value=TP_STREAMED_BUDGET),
                              server="majority_vote")
    golomb = CompressionConfig(compressor="sparsign_golomb", budget=BudgetConfig(
        kind="target_sparsity", value=TP_STREAMED_TARGET), server="majority_vote")
    ef = dataclasses.replace(fixed, server="scaled_sign_ef")
    cap = TP_BUCKET_BYTES if on_card else 2048
    pristine = net.init(0, dev)

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0

    def run(label, comp, impl, t, kind, simple=False, params=None, **kw):
        """One step from a copy of the pristine parameters (or from
        ``params``, consumed): (the whole parameters, numbers)."""
        group = make_host_mesh(m, t)
        if params is None:
            params = tree_unflatten(pristine, [x.clone() for x in tree_leaves(pristine)])
        if simple:
            step = build_train_step(net, TrainStepConfig(compression=comp, lr=lr,
                                                         vote_impl=impl, **kw), group)
        else:
            step = build_streamed_train_step(net, StreamedStepConfig(
                compression=comp, lr=lr, vote_impl=impl, **kw), group)
        state = step.shard_state(init_state(params, server=comp.server, seed=3))
        del params
        reset_peak(torch)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with plain_versions_barred():
            state, met = step(state, batch)
        sync(torch)
        sec = time.perf_counter() - t0
        counts = kernels.launch_counts()
        for k in totals:
            totals[k] += counts[k]
        if simple:   # a message a worker of each leaf (a slice a rank of a cut one)
            msgs = sum(TP_T if pl.sharded else 1 for pl in tree_leaves(step.placements))
            want = expected(sparsign_pack2bit=m * msgs, unpack2bit_sum=msgs,
                            vote_update=msgs)
        else:
            want = streamed_expected(step, kind, m)
        check(counts == want, f"S2T {label}: launches {counts}, expected {want}")
        ledger = float(np.float32(tp_slice_ledger(step, net)))
        check(float(met["wire_bytes_per_device"]) == ledger,
              f"S2T {label}: wire bytes {float(met['wire_bytes_per_device'])} against the "
              f"slice ledger {ledger}")
        peak = peak_gb()
        whole = step.whole_state(dataclasses.replace(state, ef_residual=None)).params
        del state
        res = {"step_s": sec, "peak_gb": peak, "loss": float(met["loss"]),
               "nnz_frac": float(met["nnz_frac"]),
               "nnz_dropped": float(met.get("nnz_dropped", 0.0)),
               "wire_bytes_per_device": float(met["wire_bytes_per_device"]),
               "launches": {k: v for k, v in counts.items() if v},
               "map_launches": {k: v for k, v in kernels.map_launch_counts().items() if v}}
        return whole, res

    def digests(params):
        return [bit_digest(torch, x) for x in tree_leaves(params)]

    out, dig = {}, {}
    for label, comp, impl, t, kind, kw in (
            ("psum", fixed, "psum", TP_T, "psum", {}),
            ("pack2 T=1", fixed, "allgather_packed", 1, "pack2", {}),
            ("pack2", fixed, "allgather_packed", TP_T, "pack2", {}),
            ("bucketed", fixed, "allgather_packed", TP_T, "pack2", {"bucketed": True}),
            ("bucketed capped", fixed, "allgather_packed", TP_T, "pack2",
             {"bucketed": True, "bucket_bytes": cap})):
        whole, out[label] = run(label, comp, impl, t, kind, **kw)
        dig[label] = digests(whole)
        del whole
        if on_card:
            torch.cuda.empty_cache()
    whole, out["step_tp"] = run("step_tp", fixed, "allgather_packed", TP_T, "pack2",
                                simple=True)
    dig["step_tp"] = digests(whole)
    del whole
    equal = {}   # the psum and 2-bit wires sum the same votes (tests/test_torch_streamed.py)
    for label in ("psum", "pack2", "bucketed", "bucketed capped", "step_tp"):
        equal[label] = dig[label] == dig["pack2 T=1"]
    check(all(equal.values()), f"S2T: T = {TP_T} runs whose bit digests differ from the "
                               f"streamed T = 1 2-bit run's: {equal}")
    out["digests_equal"] = equal
    # golomb under target_sparsity: T = 2 within the flip bound of T = 1
    kw = {"golomb_p": TP_STREAMED_GOLOMB_P}
    ref, out["golomb T=1"] = run("golomb T=1", golomb, "allgather_packed", 1, "golomb", **kw)
    got, out["golomb"] = run("golomb", golomb, "allgather_packed", TP_T, "golomb", **kw)
    a, b, p0 = tree_leaves(got), tree_leaves(ref), tree_leaves(pristine)
    size = sum(x.numel() for x in a)
    flips = float_flips(torch, a, b, p0)
    apart = sum(int((x.view(torch.int16) != y.view(torch.int16)).sum()) if x.element_size() == 2
                else int((x.view(torch.int32) != y.view(torch.int32)).sum())
                for x, y in zip(a, b))
    out["golomb_flips"], out["golomb_bits_apart"], out["coordinates"] = flips, apart, size
    check(flips <= TP_FLIP_BOUND * size and out["golomb"]["nnz_dropped"] == 0.0
          and out["golomb T=1"]["nnz_dropped"] == 0.0,
          f"S2T golomb: {flips} of {size} coordinates beyond float noise (bound "
          f"{TP_FLIP_BOUND}), dropped {out['golomb']['nnz_dropped']}, T = 1 "
          f"{out['golomb T=1']['nnz_dropped']}")
    del got, ref, a, b
    if on_card:
        torch.cuda.empty_cache()
    # scaled_sign_ef on psum: T = 2 to rtol 1e-6 of T = 1, the same coordinates
    # moving. The float32 residual leaves no room for a pristine copy beside
    # two runs: each run draws the parameters again from the seed, T = 1's
    # result waits in host memory
    del pristine, p0
    if on_card:
        torch.cuda.empty_cache()
    ref, out["ef T=1"] = run("ef T=1", ef, "psum", 1, "ef", params=net.init(0, dev))
    ref_host = [x.to("cpu") for x in tree_leaves(ref)]
    del ref
    if on_card:
        torch.cuda.empty_cache()
    got, out["ef"] = run("ef", ef, "psum", TP_T, "ef", params=net.init(0, dev))
    if on_card:
        torch.cuda.empty_cache()
    # rtol 1e-6 in float32 weights; in bf16 an update an ulp apart may round
    # to the next bf16 value, so the card's weights are held to float noise
    # (float_flips: 1e-5 of the largest update plus two ulps of the dtype)
    worst, moved_apart, ef_flips = 0.0, 0, 0
    for x, y, p in zip(tree_leaves(got), ref_host, tree_leaves(net.init(0, dev))):
        y = y.to(x.device)
        x32, y32 = x.float(), y.float()
        worst = max(worst, float(((x32 - y32).abs() / (y32.abs() + 1e-30)).max()))
        moved_apart += int(((x != p) != (y != p)).sum())
        ef_flips += float_flips(torch, [x], [y], [p])
        del x32, y32, y
    out["ef_max_rel"], out["ef_moved_apart"], out["ef_flips"] = worst, moved_apart, ef_flips
    f32 = all(x.dtype == torch.float32 for x in ref_host)
    check((worst <= 1e-6 if f32 else ef_flips == 0) and moved_apart == 0,
          f"S2T ef: largest relative difference from T = 1 {worst:.3g} (rtol 1e-6 in "
          f"float32), {ef_flips} coordinates beyond float noise, {moved_apart} moved on one "
          f"side only")
    del got, ref_host
    if on_card:
        torch.cuda.empty_cache()
    runs = [k for k in out if isinstance(out[k], dict) and "step_s" in out[k]]
    print(f"[tp streamed S2T] {cfg.name} at {cfg.n_layers} layers, injected gradients, M = "
          f"{m} x T = {TP_T} against T = 1 from one state, one step each: bit digests equal "
          f"{equal}; golomb target_sparsity {TP_STREAMED_TARGET} (plan {TP_STREAMED_GOLOMB_P}) "
          f"{flips} of {size} coordinates beyond float noise, {apart} in any bit, dropped "
          f"{out['golomb']['nnz_dropped']:.0f}; scaled_sign_ef largest relative difference "
          f"{worst:.3g}, {ef_flips} beyond float noise, moved on one side only {moved_apart}; "
          f"seconds, peak GB, wire bytes: "
          + "; ".join(f"{k} {out[k]['step_s']:.3f} s, {out[k]['peak_gb']:.2f} GB, "
                      f"{out[k]['wire_bytes_per_device']:.10g}" for k in runs)
          + "; launches " + "; ".join(f"{k} {out[k]['launches']}"
                                      for k in ("pack2", "bucketed", "golomb", "ef")))
    return out


def tp_streamed_line(tag: str, res: dict, t1: dict) -> None:
    """One launcher run under T = TP_T beside its T = 1 twin."""
    print(f"[tp streamed {tag}] {res['config']}, {res['layers']} layers, M = {res['workers']} "
          f"x T = {TP_T}, {res['tokens_per_worker']} tokens a worker, sparsign l2_norm 0.1, "
          f"majority vote on allgather_packed, through the launcher: step "
          f"{[round(x, 3) for x in res['step_s']]} s (T = 1 "
          f"{[round(x, 3) for x in t1['step_s']]}), peak {res['peak_gb']:.2f} GB (T = 1 "
          f"{t1['peak_gb']:.2f}; the step's {res.get('train_peak_gb', res['peak_gb']):.2f}, "
          f"init {res.get('init_peak_gb', 0.0):.2f}), wire bytes a device "
          f"{res['wire_bytes_per_device']:.10g} (== "
          f"the slice ledger; T = 1 {t1['wire_bytes_per_device']:.10g}, "
          f"{res['wire_bytes_per_device'] / t1['wire_bytes_per_device']:.5f}x), loss "
          f"{res['loss']} (T = 1 {t1['loss']}), launches a step "
          f"{res['launches']}, counter maps {res['map_launches']}")


JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_POSITIONS = (2, 5)     # pattern positions 2-4: mamba + dense, mamba + MoE, attention
JAMBA_WORKERS = 4            # M; PERF.md says what to do if the peak does not fit
HUGE_N = 16 * 8192 * 24576   # one layer's moe_w_gate: 3,221,225,472 coordinates, above 2^31
HUGE_CHUNK = 1 << 28         # the plain versions' chunk: their float32 temporaries fit
HUGE_BASE = (1 << 32) - (1 << 30)   # a counter base whose counter wraps inside the leaf
HUGE_BUDGET = 0.1            # sparsign's B on N(0, 1) coordinates: about 8 % nonzero
HUGE_SEED = 24               # the check's draws


def huge_leaf_check(torch, dev="cuda", n=HUGE_N, chunk=HUGE_CHUNK) -> dict:
    """Rows 6, 9 and 2 above 2^31 coordinates: ``sparsign_pack2bit`` of one
    bf16 gradient-sized tensor at counter base 0 and at HUGE_BASE (its
    counter wraps), ``unpack2bit_sum`` of four such messages into int8 and
    ``vote_update`` of a bf16 weight by that sum, each against its plain
    version computed ``chunk`` coordinates at a time (each chunk at its own
    counter base and offset): the count of bytes that differ, which must
    be 0. ``dev="cpu"`` rehearses it at a small ``n``, where the ops are
    the plain versions."""
    from repro_torch.kernels.pack2bit.ops import unpack2bit_sum_op
    from repro_torch.kernels.pack2bit.ref import unpack2bit_sum_ref
    from repro_torch.kernels.sparsign_pack2bit.ops import sparsign_pack2bit_op
    from repro_torch.kernels.sparsign_pack2bit.ref import sparsign_pack2bit_ref
    from repro_torch.kernels.vote_update.ops import vote_update_op
    from repro_torch.kernels.vote_update.ref import vote_update_ref

    check(n % chunk == 0 and chunk % (512 * 32) == 0, f"{n} is not whole {chunk}-chunks")
    rows, crows = n // 512, chunk // 512
    gen = torch.Generator(device=dev).manual_seed(HUGE_SEED)
    t0 = time.perf_counter()
    msgs = torch.empty((4, rows, 128), dtype=torch.uint8, device=dev)
    differ = {"sparsign_pack2bit": 0, "unpack2bit_sum": 0, "vote_update": 0}
    bases = (0, HUGE_BASE, 0, 0)
    for i, base in enumerate(bases):
        g = torch.randn(n, generator=gen, device=dev, dtype=torch.bfloat16)
        seed = 1000 + (i if i != 1 else 0)   # message 1: message 0's stream from the other base
        got = sparsign_pack2bit_op(g, HUGE_BUDGET, seed, base)
        check(tuple(got.shape) == (rows, 128), f"packed shape {tuple(got.shape)}")
        msgs[i].copy_(got)
        del got
        if i < 2:   # the plain version at both bases
            for c in range(0, n, chunk):
                want = sparsign_pack2bit_ref(g[c:c + chunk], HUGE_BUDGET, seed,
                                             (base + c) & 0xFFFFFFFF)
                r0 = c // 512
                differ["sparsign_pack2bit"] += int((msgs[i, r0:r0 + crows] != want).sum())
                del want
        del g
    votes = torch.empty(n, dtype=torch.int8, device=dev)
    unpack2bit_sum_op(msgs, n, (n,), out=votes)
    for r0 in range(0, rows, crows):
        want = unpack2bit_sum_ref(msgs[:, r0:r0 + crows],
                                  out=torch.empty(crows * 512, dtype=torch.int8, device=dev))
        differ["unpack2bit_sum"] += int((votes[r0 * 512:(r0 + crows) * 512]
                                         != want.reshape(-1)).sum())
        del want
    nnz = [int(torch.count_nonzero(votes[c:c + chunk])) for c in range(0, n, chunk)]
    del msgs
    w = torch.randn(n, generator=gen, device=dev, dtype=torch.bfloat16)
    new_w = vote_update_op(w, votes, 2.0 ** -6)
    for c in range(0, n, chunk):
        want = vote_update_ref(w[c:c + chunk], votes[c:c + chunk], 2.0 ** -6)
        differ["vote_update"] += int((new_w[c:c + chunk].view(torch.uint8)
                                      != want.view(torch.uint8)).sum())
        del want
    moved = int((new_w.view(torch.int16) != w.view(torch.int16)).sum())
    del w, new_w, votes
    sync(torch)
    return {"coordinates": n, "chunk": chunk, "bases": [0, HUGE_BASE], "budget": HUGE_BUDGET,
            "bytes_differ": differ, "vote_nonzero": sum(nnz), "weights_moved": moved,
            "seconds": time.perf_counter() - t0}


def phase_jamba(torch, report, totals, dev="cuda"):
    """jamba-1.5-large-398b at its published widths, the pattern cut to
    JAMBA_POSITIONS (``card_config``), one streamed step at M =
    JAMBA_WORKERS in one process through the launcher, launches counted
    with every plain version barred; the trained state served through the
    launcher's loop, a timed prefill and decode against the full forward;
    J1T, one launcher step at M = JAMBA_WORKERS x T = TP_T; then
    ``huge_leaf_check``. ``dev="cpu"`` rehearses it at the smoke
    widths, where only the launch counts cannot hold."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.analysis.drivers import tp_slice_ledger
    from repro_torch.configs import jamba15_large
    from repro_torch.core.compressors import tree_leaves
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch
    from repro_torch.serve.decode import build_prefill
    from repro_torch.train import loop

    on_card, m, out = dev == "cuda", JAMBA_WORKERS, {}
    seq = TRAINER_SEQ_LEN if on_card else 64
    where = (["--full", "--seq-len", str(seq)] if on_card else
             ["--device", dev, "--seq-len", str(seq)])
    get_config, serve_get_config = launch.get_config, launch_serve.get_config
    serve_model = launch_serve.Model

    def cut(arch, smoke):
        return jamba15_large.card_config(JAMBA_POSITIONS, smoke=smoke)

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0

    try:
        launch.get_config = launch_serve.get_config = cut
        # -- J1: one streamed step through the launcher --------------------
        args = launch.parser().parse_args([
            "--arch", JAMBA_ARCH, "--host-data", str(m), "--batch", str(m), "--steps", "1",
            "--seed", "0", "--compressor", "sparsign", "--budget-kind", "l2_norm",
            "--budget", "0.1", "--server", "majority_vote", "--vote-impl",
            "allgather_packed"] + where)
        reset_peak(torch)
        t0 = time.perf_counter()
        cfg, model, group, step, state, comp = launch.build_everything(args)
        sync(torch)
        init_s = time.perf_counter() - t0
        init_peak = peak_gb()
        reset_peak(torch)
        kernels.reset_launch_counts()
        with plain_versions_barred():
            state, history = loop.run(step, state, launch.batch_fn_for(cfg, args),
                                      loop.LoopConfig(total_steps=1, log_every=1),
                                      log=lambda line: None)
        sync(torch)
        counts = kernels.launch_counts()
        for k in totals:
            totals[k] += counts[k]
        shapes = model.param_shapes()
        n_blk = len(tree_leaves(shapes["blocks"]))
        per_step = cfg.n_repeats * n_blk + len(tree_leaves(shapes)) - n_blk
        want = expected(sparsign_pack2bit=m * per_step, unpack2bit_sum=per_step,
                        vote_update=per_step)
        check(counts == want, f"J1: launches {counts}, expected {want}")
        h = history[0]
        ledger = float(np.float32(step.ledger[0]))
        check(math.isfinite(h["loss"]) and h["wire_bytes_per_device"] == ledger,
              f"J1: {h} against the streamed ledger {ledger}")
        check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params)),
              "J1: non-finite parameters")
        sizes = [math.prod(s.shape) for s in tree_leaves(shapes)]
        j1 = {"config": cfg.name, "layers": cfg.n_layers, "parameters": model.param_count(),
              "superblock": sum(math.prod(s.shape) for s in tree_leaves(shapes["blocks"])),
              "largest_leaf": max(sizes), "workers": m, "tokens_per_worker": seq,
              "init_s": init_s, "init_peak_gb": init_peak, "step_s": h["wall_s"],
              "loss": h["loss"], "nnz_frac": h["nnz_frac"],
              "nnz_dropped": h.get("nnz_dropped", 0.0), "wire_bytes_per_device": ledger,
              "peak_gb": peak_gb(), "launches": counts, "exchanges_a_step": per_step}
        print(f"[jamba J1] {cfg.name}: pattern positions {JAMBA_POSITIONS[0]}-"
              f"{JAMBA_POSITIONS[1] - 1} ({', '.join(s.mixer + ('+MoE' if s.moe else '+dense') + ('' if s.use_rope else ' no RoPE') for s in cfg.pattern)}) at d_model "
              f"{cfg.d_model}, {cfg.n_heads}:{cfg.n_kv_heads} heads, {cfg.n_experts} experts "
              f"top {cfg.top_k} of d_ff {cfg.moe_d_ff}, ssm_state {cfg.ssm_state}, "
              f"{cfg.ssm_heads} SSD heads, vocab {cfg.vocab_size}; {j1['parameters']} "
              f"parameters, superblock {j1['superblock']}, largest leaf {j1['largest_leaf']}; "
              f"M = {m}, {seq} tokens a worker, sparsign l2_norm 0.1, majority vote on "
              f"allgather_packed: init {init_s:.1f} s (peak {init_peak:.2f} GB), step "
              f"{j1['step_s']:.3f} s, loss {j1['loss']:.6f}, nnz_frac {j1['nnz_frac']:.4g}, "
              f"dropped {j1['nnz_dropped']:.0f}, wire bytes {ledger:.10g} (== the streamed "
              f"ledger), peak {j1['peak_gb']:.2f} GB, launches a step "
              f"{ {k: v for k, v in counts.items() if v} }")
        out["J1"] = j1
        params = state.params
        del step, state

        # -- serving the trained state at the same depth --------------------
        class Trained(serve_model):   # the launcher's model, with the trained weights
            def init(self, seed, device=None):
                return params

        launch_serve.Model = Trained
        serve_args = (["--arch", JAMBA_ARCH] + ZOO_SERVE_ARGS if on_card else
                      ["--arch", JAMBA_ARCH] + [a for a in ZOO_SERVE_ARGS if a != "--full"]
                      + ["--device", dev])
        reset_peak(torch)
        serve_loop = launch_serve.main(serve_args)
        sync(torch)
        serve_loop["peak_gb"] = peak_gb()
        prefill_len = PREFILL_LEN if on_card else 40
        s = PREFILL_LEN if on_card else 24
        gen = torch.Generator(device=dev).manual_seed(5)
        toks = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, max(prefill_len, s + 2)),
                             generator=gen, device=dev, dtype=torch.int32)
        pos = torch.arange(toks.shape[1], device=dev, dtype=torch.int32).expand(
            PREFILL_BATCH, -1)
        prefill = build_prefill(model)
        pbatch = {"inputs": toks[:, :prefill_len], "positions": pos[:, :prefill_len]}
        prefill(params, pbatch)   # warm: the first call's allocations
        reset_peak(torch)
        sync(torch)
        t0 = time.perf_counter()
        logits, caches = prefill(params, pbatch)
        sync(torch)
        prefill_s = time.perf_counter() - t0
        check(tuple(logits.shape) == (PREFILL_BATCH, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()), "J1 prefill: logits not finite or "
                                                      "misshapen")
        prefill_peak = peak_gb()
        del logits, caches
        rel, floor, agree = decode_vs_forward(torch, model, params, toks, pos, s)
        check(rel <= MAMBA_DECODE_REL_TOL and agree == 1.0,
              f"J1 decode of token {s}: {rel:.3g} of max |logit| from the full forward "
              f"(tolerance {MAMBA_DECODE_REL_TOL}), argmax agrees for {agree:.0%}")
        out["serve"] = {"loop": serve_loop, "prefill": {
            "batch": PREFILL_BATCH, "tokens": prefill_len, "seconds": prefill_s,
            "tokens_per_s": PREFILL_BATCH * prefill_len / prefill_s, "peak_gb": prefill_peak},
            "decode_vs_forward": {"prompt": s, "rel_err": rel, "longer_forward_rel": floor,
                                  "argmax_agree": agree, "tol": MAMBA_DECODE_REL_TOL}}
        print(f"[jamba J1] launch.serve {' '.join(serve_args)} on the trained state: decode "
              f"{serve_loop['decode_ms_median']:.2f} ms a token, peak "
              f"{serve_loop['peak_gb']:.2f} GB; prefill {PREFILL_BATCH} x {prefill_len} "
              f"tokens {prefill_s * 1e3:.1f} ms ({PREFILL_BATCH * prefill_len / prefill_s:.0f} "
              f"tokens/s), peak {prefill_peak:.2f} GB; decode of token {s} after a {s}-token "
              f"prefill vs forward_hidden: max |diff| {rel:.4g} of max |logit| (a forward one "
              f"token longer {floor:.4g}; tolerance {MAMBA_DECODE_REL_TOL}), argmax agrees for "
              f"{agree:.0%}")
        del params, model, prefill, toks, pos
        if on_card:
            torch.cuda.empty_cache()

        # -- J1T: the card cut under a 'model' axis of TP_T -----------------
        args = launch.parser().parse_args([
            "--arch", JAMBA_ARCH, "--host-data", str(m), "--host-model", str(TP_T), "--batch",
            str(m), "--steps", "1", "--seed", "0", "--compressor", "sparsign", "--budget-kind",
            "l2_norm", "--budget", "0.1", "--server", "majority_vote", "--vote-impl",
            "allgather_packed"] + where)
        reset_peak(torch)
        t0 = time.perf_counter()
        cfg, model, group, step, state, comp = launch.build_everything(args)
        sync(torch)
        init_s = time.perf_counter() - t0
        init_peak = peak_gb()
        reset_peak(torch)
        kernels.reset_launch_counts()
        with plain_versions_barred():
            state, history = loop.run(step, state, launch.batch_fn_for(cfg, args),
                                      loop.LoopConfig(total_steps=1, log_every=1),
                                      log=lambda line: None)
        sync(torch)
        counts = kernels.launch_counts()
        for k in totals:
            totals[k] += counts[k]
        want = streamed_expected(step, "pack2", m)
        check(counts == want, f"J1T: launches {counts}, expected {want}")
        h = history[0]
        ledger = float(np.float32(tp_slice_ledger(step, model)))
        check(math.isfinite(h["loss"]) and h["wire_bytes_per_device"] == ledger,
              f"J1T: {h} against the slice ledger {ledger}")
        check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params)),
              "J1T: non-finite parameters")
        j1t = {"config": cfg.name, "layers": cfg.n_layers, "workers": m,
               "tokens_per_worker": seq, "init_s": init_s, "step_s": [h["wall_s"]],
               "loss": h["loss"], "nnz_frac": h["nnz_frac"], "wire_bytes_per_device": ledger,
               "peak_gb": peak_gb(), "init_peak_gb": init_peak,
               "launches": {k: v for k, v in counts.items() if v},
               "map_launches": {k: v for k, v in kernels.map_launch_counts().items() if v}}
        tp_streamed_line("J1T", j1t, {**j1, "step_s": [j1["step_s"]]})
        out["J1T"] = j1t
        del step, state, model
        if on_card:
            torch.cuda.empty_cache()
    finally:
        launch.get_config, launch_serve.get_config = get_config, serve_get_config
        launch_serve.Model = serve_model

    # -- rows 6, 9, 2 above 2^31 coordinates, the state freed ---------------
    reset_peak(torch)
    huge = huge_leaf_check(torch, dev) if on_card else huge_leaf_check(
        torch, dev, n=3 * (1 << 14), chunk=1 << 14)
    huge["peak_gb"] = peak_gb()
    check(not any(huge["bytes_differ"].values()),
          f"above 2^31: bytes that differ from the chunked plain versions "
          f"{huge['bytes_differ']}")
    check(huge["vote_nonzero"] > 0 and huge["weights_moved"] > 0,
          f"above 2^31: a vacuous check {huge}")
    print(f"[jamba J1] above 2^31: {huge['coordinates']} bf16 coordinates (one moe_w_gate "
          f"leaf), sparsign_pack2bit at counter bases 0 and {HUGE_BASE} (the counter wraps), "
          f"unpack2bit_sum of 4 messages into int8 ({huge['vote_nonzero']} nonzero sums), "
          f"vote_update of a bf16 weight ({huge['weights_moved']} moved) against the plain "
          f"versions in {huge['chunk']}-coordinate chunks: bytes that differ "
          f"{huge['bytes_differ']}, {huge['seconds']:.1f} s, peak {huge['peak_gb']:.2f} GB")
    out["above_2_31"] = huge
    report["jamba"] = out


# ---------------------------------------------------------------------------
# phase_tp: the tensor-parallel 'model' axis on the simple trainer
# ---------------------------------------------------------------------------

TP_T = 2             # model ranks
TP_LAYERS = 4        # the runs held against T = 1, from one state and one batch
# The model's own float32 gradients at T = 2 are held against float64, not
# against T = 1's bits: at full width and random init, T = 1's float32
# gradients themselves lie up to 12 % of a block leaf's norm from float64
# (PERF.md, section 6), so T = 1 and T = 2 flip a share of their symbols apart
# whatever the split. Each leaf's T = 2 error to float64 may exceed T = 1's by
# this factor
TP_F64_RATIO = 1.25
# The families' float64 checks (``tp_family``) hold the same ratio at
# TP_FAMILY_F64_LAYERS layers, plus a floor of 32 float32 ulps of the leaf's
# norm: mamba2-370m's smoke rehearsal on the CPU lies near 1e-6 of a leaf's
# norm from float64, where the ratio of two float32 runs is the rounding's
# draw
TP_F64_FLOOR = 32 * 2.0 ** -23
# PERF.md's kernel table (section 6): the contiguous rows' card ms that the
# slices are timed beside, on "NVIDIA H100 80GB HBM3, 700.00 W"; this run's
# own times are printed against them, a change beyond 3 % marked
PERF6_MS = {"sparsign 100x545002 f32": 0.1046,
            "sparsign_pack2bit w_down bf16": 0.5359,
            "ternary_pack2bit sign w_down bf16": 0.5275,
            "ternary_pack2bit sparsign w_down bf16": 0.5360,
            "qsgd8_pack8 w_down bf16": 0.7404}
# the slices of rows 1, 5, 6 and 12's holds: one layer's w_up (2,560 x 6,912)
# cut on its columns, and lm_head (2,560 x 151,936) on its vocabulary
TP_SLICE_SHAPES = {"w_up": (2560, 6912), "lm_head": (2560, 151936)}


class InjectedGrads:
    """A model's parameter tree whose loss is sum_i <p_i, g_i>, the worker's
    gradients g_i taken from the batch (``g{i}``, one leading row a worker):
    autograd's gradient of leaf i is g_i exactly, so two trainers compress
    the same numbers. Its tensor-parallel form gives each model rank its
    slice of g_i."""

    def __init__(self, model):
        self.model = model

    def param_shapes(self):
        return self.model.param_shapes()

    def param_logical_axes(self):
        return self.model.param_logical_axes()

    def loss(self, params, batch):
        from repro_torch.core.compressors import tree_leaves
        total = sum(torch_sum(p, batch[f"g{i}"][0]) for i, p in enumerate(tree_leaves(params)))
        return total, {"loss": total}

    def tensor_parallel(self, mg):
        return _InjectedTP(self.model, mg)


class _InjectedTP:
    def __init__(self, model, mg):
        from repro_torch.models import tensor_parallel as tpl
        self.mg, self.tpl = mg, tpl
        self.placements = tpl.placements_for(model, mg.size)

    def loss(self, params, batch):
        from repro_torch.core.compressors import tree_leaves
        total = sum(torch_sum(p, self.tpl.shard_leaf(batch[f"g{i}"][0], pl, self.mg))
                    for i, (p, pl) in enumerate(zip(tree_leaves(params),
                                                    tree_leaves(self.placements))))
        return total, {"loss": total}


def torch_sum(p, g):
    """<p, g> in float32: its gradient with respect to p is g, exactly."""
    return (p.float() * g.float()).sum()


#: the row-4 rules held on slices, with their params (stochastic_ternary's
#: scale and noisy_sign's sigma against N(0, 0.01) gradients)
TP_TERNARY_PARAMS = {"stochastic_ternary": 0.02, "sign": 0.0, "noisy_sign": 0.01}
#: row 14's budget on the slices: about 5 % nonzero on N(0, 0.01) gradients
TP_GOLOMB_BUDGET = 6.0
#: the two map kernels this slice added, their slice-hold labels: the kernels
#: line lists their counter-map launches beside their rows
TP_NEW_MAPS = {"ternary": "ternary stochastic_ternary (row 4)",
               "sparsign_golomb": "sparsign_golomb (row 14)"}


def tp_slice_holds(torch, timer, report, dev="cuda", shapes=None):
    """Rows 1, 4 (the stochastic_ternary, sign and noisy_sign rules), 5 (the
    sign and the sparsign rule), 6, 12 and 14 on model rank 1's slice at
    T = 2 of each TP_SLICE_SHAPES leaf in bf16 (w_up: run L = 3,456 of G =
    6,912 at offset o = 3,456; lm_head: 75,968 of 151,936): bit for bit
    against their plain versions on the same inputs, each timed beside the
    same kernel on as many contiguous coordinates; rows 4 and 14's plain
    versions timed too (the kernels line)."""
    from repro_torch.kernels.common import canonical_rows
    from repro_torch.kernels.golomb.ops import sparsign_golomb_op
    from repro_torch.kernels.golomb.ref import golomb_rows, sparsign_golomb_ref
    from repro_torch.kernels.pack8.ops import qsgd8_pack8_op
    from repro_torch.kernels.pack8.ref import qsgd8_pack8_ref
    from repro_torch.kernels.sparsign.ops import sparsign_op
    from repro_torch.kernels.sparsign.ref import sparsign_ref
    from repro_torch.kernels.sparsign_pack2bit.ops import sparsign_pack2bit_op
    from repro_torch.kernels.sparsign_pack2bit.ref import sparsign_pack2bit_ref
    from repro_torch.kernels.ternary.ops import ternary_compress_op, ternary_pack2bit_op
    from repro_torch.kernels.ternary.ref import ternary_compress_ref, ternary_pack2bit_ref

    gen = torch.Generator(device=dev).manual_seed(25)
    out = {}
    for name, (rows, cols) in (shapes or TP_SLICE_SHAPES).items():
        g = (torch.randn((rows, cols), generator=gen, device=dev) * 0.01).to(torch.bfloat16)
        run = cols // TP_T
        cmap = (run, cols, run)            # model rank 1's slice
        s = g[:, run:].contiguous()
        flat = g.reshape(-1)[:s.numel()]   # as many contiguous coordinates
        n = s.numel()
        base, seed, budget = 4096, 12345, 50.0
        scale = torch.tensor(0.0005, device=dev)
        pack_bytes = n * 2 + canonical_rows(n) * 128
        cases = {  # row: (kernel on the slice, its plain version, contiguous kernel, bytes)
            "sparsign (row 1)": (
                lambda: sparsign_op(s, budget, seed, base, counter_map=cmap),
                lambda: sparsign_ref(s, budget, seed, base, counter_map=cmap),
                lambda: sparsign_op(flat, budget, seed, base), n * 3),
            "ternary_pack2bit sign (row 5)": (
                lambda: ternary_pack2bit_op(s, 0.0, seed, base, rule="sign", counter_map=cmap),
                lambda: ternary_pack2bit_ref(s, 0.0, seed, base, rule="sign", counter_map=cmap),
                lambda: ternary_pack2bit_op(flat, 0.0, seed, base, rule="sign"), pack_bytes),
            "ternary_pack2bit sparsign (row 5)": (
                lambda: ternary_pack2bit_op(s, budget, seed, base, rule="sparsign",
                                            counter_map=cmap),
                lambda: ternary_pack2bit_ref(s, budget, seed, base, rule="sparsign",
                                             counter_map=cmap),
                lambda: ternary_pack2bit_op(flat, budget, seed, base, rule="sparsign"),
                pack_bytes),
            "sparsign_pack2bit (row 6)": (
                lambda: sparsign_pack2bit_op(s, budget, seed, base, counter_map=cmap),
                lambda: sparsign_pack2bit_ref(s, budget, seed, base, counter_map=cmap),
                lambda: sparsign_pack2bit_op(flat, budget, seed, base), pack_bytes),
            "qsgd8_pack8 (row 12)": (
                lambda: qsgd8_pack8_op(s, scale, seed, base, counter_map=cmap),
                lambda: qsgd8_pack8_ref(s, scale, seed, base, counter_map=cmap),
                lambda: qsgd8_pack8_op(flat, scale, seed, base), n * 2 + canonical_rows(n) * 512),
            "sparsign_golomb (row 14)": (
                lambda: sparsign_golomb_op(s, TP_GOLOMB_BUDGET, seed, base, p=GOLOMB_P,
                                           counter_map=cmap, leaf_n=g.numel()),
                lambda: sparsign_golomb_ref(s, TP_GOLOMB_BUDGET, seed, base, p=GOLOMB_P,
                                            counter_map=cmap, leaf_n=g.numel()),
                lambda: sparsign_golomb_op(flat, TP_GOLOMB_BUDGET, seed, base, p=GOLOMB_P),
                n * 2 + golomb_rows(n, GOLOMB_P, g.numel()) * 128),
        }
        for rule, prm in TP_TERNARY_PARAMS.items():
            cases[f"ternary {rule} (row 4)"] = (
                lambda rule=rule, prm=prm: ternary_compress_op(s, prm, seed, base, rule=rule,
                                                               counter_map=cmap),
                lambda rule=rule, prm=prm: ternary_compress_ref(s, prm, seed, base, rule=rule,
                                                                counter_map=cmap),
                lambda rule=rule, prm=prm: ternary_compress_op(flat, prm, seed, base, rule=rule),
                n * 3)
        # the whole leaf's symbols at the slice's coordinates, for row 1
        whole = sparsign_ref(g, budget, seed, base)[:, run:]
        res = {}
        for label, (kern, plain, contiguous, nbytes) in cases.items():
            a, b = kern(), plain()
            err = max_abs_err(a, b)
            check(same_bits(a, b), f"tp {name} {label}: the slice's kernel differs from its "
                                   f"plain version (max |err| {err})")
            if label.startswith("sparsign (row 1)"):
                check(torch.equal(a, whole), f"tp {name}: the slice's symbols are not the "
                                             f"whole leaf's")
            if label.startswith("sparsign_golomb"):
                shipped, dropped = golomb_header(a)
                check(dropped == 0, f"tp {name} {label}: {dropped} nonzeros dropped")
            t_map, t_flat = timer(kern)["ms"], timer(contiguous)["ms"]
            rule = label.split()[1] if label.startswith("ternary ") else None
            b_ms, b_by = bound(nbytes, rule_ops(rule, 1, n) if rule in OPS_PER_COORD else 0)
            res[label] = {"ms": t_map, "contiguous_ms": t_flat, "bound_ms": b_ms,
                          "bound_by": b_by, "max_abs_err": err, "coords": n}
            if label in TP_NEW_MAPS.values():
                res[label]["plain_ms"] = timer(plain, reps=3, warmup=1)["ms"]
            print(f"[tp] {name} slice ({rows} x {run} of {cols}, L {run} G {cols} o {run}) "
                  f"{label}: 0 bytes from the plain version; kernel {t_map:.4f} ms, contiguous "
                  f"{t_flat:.4f} ms ({t_map / t_flat - 1:+.1%}), bound {b_ms:.4f} ms")
        out[name] = res
        del g, s, flat, whole
    return out


#: the short-run holds: a leaf of TP_SHORT_LEAF coordinates a row, slices of
#: 252 (at offset 252) and 17 (at 34) coordinates a row, at counter base 0 and
#: at one whose counter wraps inside the slice
TP_SHORT_LEAF = (64, 504)
TP_SHORT_MAPS = ((252, 252), (17, 34))
TP_SHORT_BASES = (0, (1 << 32) - 5000)


def tp_short_runs(torch, dev="cuda") -> dict:
    """Every counter-map kernel (rows 1, 4, 5, 6, 12, 14) on slices of
    TP_SHORT_MAPS' runs of a bf16 leaf, at each TP_SHORT_BASES base: bit for
    bit against its plain version, and the plain version against the whole
    leaf's symbols at the slice's coordinates (rows 1 and 4)."""
    from repro_torch.kernels.golomb.ops import sparsign_golomb_op
    from repro_torch.kernels.golomb.ref import sparsign_golomb_ref
    from repro_torch.kernels.pack8.ops import qsgd8_pack8_op
    from repro_torch.kernels.pack8.ref import qsgd8_pack8_ref
    from repro_torch.kernels.sparsign.ops import sparsign_op
    from repro_torch.kernels.sparsign.ref import sparsign_ref
    from repro_torch.kernels.sparsign_pack2bit.ops import sparsign_pack2bit_op
    from repro_torch.kernels.sparsign_pack2bit.ref import sparsign_pack2bit_ref
    from repro_torch.kernels.ternary.ops import ternary_compress_op, ternary_pack2bit_op
    from repro_torch.kernels.ternary.ref import ternary_compress_ref, ternary_pack2bit_ref

    gen = torch.Generator(device=dev).manual_seed(26)
    rows, leaf_run = TP_SHORT_LEAF
    g = (torch.randn(TP_SHORT_LEAF, generator=gen, device=dev) * 0.01).to(torch.bfloat16)
    scale = torch.tensor(0.0005, device=dev)
    held = 0
    for (run, off), base in itertools.product(TP_SHORT_MAPS, TP_SHORT_BASES):
        s = g[:, off:off + run].contiguous()
        cmap = (run, leaf_run, off)
        pairs = {
            "sparsign": (sparsign_op, sparsign_ref, 50.0, {}),
            "sparsign_pack2bit": (sparsign_pack2bit_op, sparsign_pack2bit_ref, 50.0, {}),
            "qsgd8_pack8": (qsgd8_pack8_op, qsgd8_pack8_ref, scale, {}),
            "sparsign_golomb": (sparsign_golomb_op, sparsign_golomb_ref, TP_GOLOMB_BUDGET,
                                {"p": GOLOMB_P, "leaf_n": g.numel()}),
        }
        for rule, prm in TP_TERNARY_PARAMS.items():
            pairs[f"ternary {rule}"] = (ternary_compress_op, ternary_compress_ref, prm,
                                        {"rule": rule})
            pairs[f"ternary_pack2bit {rule}"] = (ternary_pack2bit_op, ternary_pack2bit_ref, prm,
                                                 {"rule": rule})
        for label, (op, ref, prm, kw) in pairs.items():
            a = op(s, prm, 12345, base, counter_map=cmap, **kw)
            b = ref(s, prm, 12345, base, counter_map=cmap, **kw)
            check(same_bits(a, b), f"tp short run {run} at {off}, base {base}: {label}'s "
                                   f"kernel differs from its plain version")
            held += 1
        whole = sparsign_ref(g, 50.0, 12345, base)[:, off:off + run]
        check(torch.equal(sparsign_op(s, 50.0, 12345, base, counter_map=cmap), whole),
              f"tp short run {run}: the slice's symbols are not the whole leaf's")
        whole = ternary_compress_ref(g, 0.02, 12345, base, rule="stochastic_ternary")
        check(torch.equal(ternary_compress_op(s, 0.02, 12345, base, rule="stochastic_ternary",
                                              counter_map=cmap), whole[:, off:off + run]),
              f"tp short run {run}: row 4's slice symbols are not the whole leaf's")
    print(f"[tp] short runs ({rows} rows of {leaf_run}: runs {[r for r, _ in TP_SHORT_MAPS]} "
          f"at bases {list(TP_SHORT_BASES)}): {held} kernel calls 0 bytes from their plain "
          f"versions; rows 1 and 4 equal the whole leaf's symbols")
    return {"held": held}


def tp_contiguous_rows(report) -> dict:
    """This run's contiguous timings of the rows the slices use, against
    PERF6_MS: within 3 % each (printed; card-to-card noise reached 2.7 %)."""
    times = {**report.get("timings", {}), **report.get("wire_timings", {}),
             **report.get("pack8_timings", {})}
    out = {}
    for key, ms in PERF6_MS.items():
        if key not in times:
            continue
        now = times[key]["ms"]
        out[key] = {"ms": now, "perf_md_ms": ms, "change": now / ms - 1}
        print(f"[tp] contiguous {key}: {now:.4f} ms against PERF.md's {ms:.4f} "
              f"({now / ms - 1:+.2%}){'' if abs(now / ms - 1) <= 0.03 else ' -- beyond 3 %'}")
    return out


def tp_injected_batch(torch, model, m: int, seed: int, dev):
    """Per-worker gradients of every leaf (M rows), in the leaves' dtype."""
    from repro_torch.core.compressors import tree_leaves
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for i, sd in enumerate(tree_leaves(model.param_shapes())):
        g = torch.empty((m,) + tuple(sd.shape), dtype=sd.dtype, device=dev)
        for w in range(m):
            g[w].copy_(torch.randn(tuple(sd.shape), generator=gen, device=dev) * 0.02)
        out[f"g{i}"] = g
    return out


def phase_tp(torch, report, totals, dev="cuda", timer=None, slice_shapes=None,
             family_maps=None):
    """The tensor-parallel 'model' axis at T = 2, qwen1.5-4b at its published
    width, in one process (the card is one; NCCL takes one rank a device):
    the four counter-map kernels on slices; 40 layers, M = 4 workers x T = 2
    model ranks, two steps of sparsign l2_norm 0.1 with majority vote on
    allgather_packed through the launcher (launches counted with every plain
    version barred, wire bytes == the slice ledger); at TP_LAYERS layers from
    one state and one batch, the T = 2 round against T = 1: injected
    gradients on psum and allgather_packed bit for bit, scaled_sign_ef to
    rtol 1e-6, the model's own gradients in float32 and bf16 (the share of
    updated coordinates that differ printed; in float32 each leaf's gradient
    no farther from float64 than TP_F64_RATIO times T = 1's); the bucketed
    uplink and the ring (``tp_bucketed_runs``) and one launcher step each with
    ``--bucketed --bucket-bytes`` and ``--ring`` (``tp_launcher_runs``); a
    checkpoint saved at T = 2 restored at T = 1 bit for bit; then the MoE and
    mamba2 families (``tp_family_runs``: qwen2-moe-a2.7b's experts on 'model',
    mamba2-370m's mixer split by heads). ``dev="cpu"`` rehearses it at the
    smoke size (``family_maps``: smaller leaves for the families' map
    holds)."""
    import tempfile

    import numpy as np

    from repro_torch import kernels
    from repro_torch.analysis.drivers import tp_slice_ledger
    from repro_torch.core.algorithm import CompressionConfig
    from repro_torch.core.budgets import BudgetConfig
    from repro_torch.core.compressors import tree_leaves
    from repro_torch.dist import collectives
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop
    from repro_torch.train.state import LrSchedule, init_state
    from repro_torch.train.step_simple import TrainStepConfig, build_train_step

    out = report["tp"] = {}
    m = 4
    if timer is None:
        timer = Timer(torch)
    out["slices"] = tp_slice_holds(torch, timer, report, dev, slice_shapes)
    out["short_runs"] = tp_short_runs(torch, dev)
    out["contiguous"] = tp_contiguous_rows(report)

    # -- 40 layers (the smoke config's depth on the CPU), M = 4 x T = 2
    where = (["--full", "--seq-len", str(TRAINER_SEQ_LEN)] if dev == "cuda"
             else ["--device", dev, "--seq-len", "64"])
    args = launch.parser().parse_args(
        ["--arch", "qwen1.5-4b", "--host-data", str(m), "--host-model", str(TP_T), "--batch",
         str(m), "--steps", "2", "--seed", "0", "--compressor", "sparsign", "--budget-kind",
         "l2_norm", "--budget", "0.1", "--server", "majority_vote", "--vote-impl",
         "allgather_packed"] + where)
    reset_peak(torch)
    t0 = time.perf_counter()
    cfg, model, group, step, state, comp = launch.build_everything(args)
    sync(torch)
    build_s = time.perf_counter() - t0
    pls = tree_leaves(step.placements)
    sizes = [math.prod(sd.shape) for sd in tree_leaves(model.param_shapes())]
    msgs = sum(TP_T if pl.sharded else 1 for pl in pls)   # a worker's messages a step
    ledger = float(np.float32(tp_slice_ledger(step, model)))
    whole_ledger = float(np.float32(sum(collectives.uplink_ledger(step.mode, step.wire, n)
                                        for n in sizes)))
    kernels.reset_launch_counts()
    with plain_versions_barred():
        state, history = loop.run(step, state, launch.batch_fn_for(cfg, args),
                                  loop.LoopConfig(total_steps=2, log_every=1),
                                  log=lambda line: None)
    sync(torch)
    counts = kernels.launch_counts()
    want = expected(sparsign_pack2bit=msgs * m * 2, unpack2bit_sum=msgs * 2,
                    vote_update=msgs * 2)
    check(counts == want, f"tp: launches {counts}, expected {want}")
    for k in totals:
        totals[k] += counts[k]
    walls = [h["wall_s"] for h in history]
    step_s = [b - a for a, b in zip([0.0] + walls[:-1], walls)]
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else 0.0
    for h in history:
        check(math.isfinite(h["loss"]), f"tp: non-finite loss {h['loss']}")
        check(h["wire_bytes_per_device"] == ledger,
              f"tp: wire bytes {h['wire_bytes_per_device']} != the slice ledger {ledger}")
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params)),
          "tp: non-finite parameters")
    out["full"] = {"layers": cfg.n_layers, "workers": m, "model_ranks": TP_T,
                   "tokens_per_worker": args.seq_len, "parameters": sum(sizes),
                   "messages_a_worker": msgs, "build_s": build_s, "step_s": step_s,
                   "peak_gb": peak, "loss": [h["loss"] for h in history],
                   "nnz_frac": [h["nnz_frac"] for h in history],
                   "wire_bytes_per_device": ledger, "whole_leaf_ledger": whole_ledger,
                   "launches": counts}
    print(f"[tp] qwen1.5-4b {cfg.n_layers} layers at d_model {cfg.d_model}, M = {m} x T = "
          f"{TP_T} ({sum(sizes)} parameters, {msgs} messages a worker): build {build_s:.2f} s, "
          f"steps {[round(x, 3) for x in step_s]} s, peak {peak:.2f} GB, losses "
          f"{[round(h['loss'], 6) for h in history]}, nnz "
          f"{[round(h['nnz_frac'], 6) for h in history]}, wire bytes {ledger:.10g} (== the "
          f"slice ledger; whole leaves {whole_ledger:.10g}), launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    del step, state, model
    if dev == "cuda":
        torch.cuda.empty_cache()

    # -- TP_LAYERS layers: T = 2 against T = 1 from one state and one batch
    base_cfg = launch.get_config("qwen1.5-4b", smoke=dev != "cuda")
    layers = min(TP_LAYERS, base_cfg.n_layers)

    def cut(dtype=None):
        c = dataclasses.replace(base_cfg, n_layers=layers)
        return dataclasses.replace(c, dtype=dtype) if dtype else c

    map_totals = out["map_launches"] = {k: 0 for k in kernels.map_launch_counts()}

    def one_round(net, comp, impl, t, params, batch, **kw):
        step = build_train_step(net, TrainStepConfig(
            compression=comp, lr=LrSchedule(base=0.05), vote_impl=impl, **kw),
            make_host_mesh(m, t))
        st = init_state(params, server=comp.server, seed=7)
        if t > 1:
            st = step.shard_state(st)
        kernels.reset_launch_counts()
        with plain_versions_barred():
            st, metrics = step(st, batch)
        sync(torch)
        counts = kernels.launch_counts()
        if t > 1:
            for k, v in kernels.map_launch_counts().items():
                map_totals[k] += v
        whole = step.whole_state(st) if t > 1 else st
        return whole, {k: float(v) for k, v in metrics.items()}, counts, step

    def clone(tree):
        return [p.clone() for p in tree_leaves(tree)]

    fixed = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                              server="majority_vote")
    ef = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                           server="scaled_sign_ef")
    model = Model(cut())
    net = InjectedGrads(model)
    leaves = len(tree_leaves(model.param_shapes()))
    pls = tree_leaves(net.tensor_parallel(make_host_mesh(m, TP_T).model).placements)
    msgs = sum(TP_T if pl.sharded else 1 for pl in pls)
    params = model.init(3, dev)
    batch = tp_injected_batch(torch, model, m, 11, dev)
    injected = {}
    for label, comp, impl, per_t in (
            ("fixed psum", fixed, "psum",
             {1: dict(sparsign=leaves * m, vote_update=leaves),
              TP_T: dict(sparsign=msgs * m, vote_update=msgs)}),
            ("fixed allgather_packed", fixed, "allgather_packed",
             {1: dict(sparsign_pack2bit=leaves * m, unpack2bit_sum=leaves, vote_update=leaves),
              TP_T: dict(sparsign_pack2bit=msgs * m, unpack2bit_sum=msgs, vote_update=msgs)}),
            ("scaled_sign_ef psum", ef, "psum",
             {1: dict(sparsign=leaves * m, ef_server=leaves),
              TP_T: dict(sparsign=msgs * m, ef_server=msgs)})):
        res = {}
        for t in (1, TP_T):
            whole, metrics, counts, _ = one_round(net, comp, impl, t,
                                                  tree_unflatten_like(model, clone(params)),
                                                  batch)
            check(counts == expected(**per_t[t]),
                  f"tp injected {label} T = {t}: launches {counts}, expected "
                  f"{expected(**per_t[t])}")
            if t > 1:
                for k in totals:
                    totals[k] += counts[k]
            res[t] = whole
        a, b = tree_leaves(res[TP_T].params), tree_leaves(res[1].params)
        differ = sum(int((bits(x) != bits(y)).sum()) for x, y in zip(a, b))
        moved_alike = all(torch.equal(x != p, y != p) for x, y, p in
                          zip(a, b, tree_leaves(params)))
        if comp.server == "majority_vote":
            check(differ == 0, f"tp injected {label}: T = {TP_T} differs from T = 1 in "
                               f"{differ} coordinates")
        else:   # the L1's order of sums: held as the CPU test holds it
            check(moved_alike and all(torch.allclose(x.float(), y.float(), rtol=1e-6, atol=0)
                                      for x, y in zip(a, b)),
                  f"tp injected {label}: beyond rtol 1e-6 of T = 1")
        injected[label] = {"differ": differ, "moved_alike": moved_alike,
                           "coords": sum(x.numel() for x in a)}
        print(f"[tp] {layers} layers, injected gradients, {label}: T = {TP_T} against T = 1, "
              f"{differ} of {injected[label]['coords']} coordinates differ, the same "
              f"coordinates moved: {moved_alike}")
        del res
    out["injected"] = injected
    out["round"] = tp_round_runs(torch, one_round, net, model, params, batch, totals, m, msgs,
                                 leaves, pls)
    out["bucketed"] = tp_bucketed_runs(torch, one_round, net, model, params, batch, totals, m,
                                       msgs, leaves, pls, dev)
    check(all(map_totals[k] > 0 for k in TP_NEW_MAPS),
          f"tp: counter-map launches {map_totals}: a new map kernel never ran on the path")
    print(f"[tp] counter-map launches on the path: {map_totals}")
    del batch, net

    # -- the model's own gradients: one round in float32 and bf16 (printed),
    # then float32 against float64 (bounded)
    full_comp = CompressionConfig(compressor="sparsign",
                                  budget=BudgetConfig(kind="l2_norm", value=0.1),
                                  server="majority_vote")
    own = {}
    tp_state = None
    lm_args = launch.parser().parse_args(["--arch", "qwen1.5-4b", "--batch", str(m), "--seed",
                                          "0"] + where)
    for dtype in ("float32", "bfloat16"):
        net = Model(cut(dtype))
        p0 = net.init(3, dev)
        batch = launch.batch_fn_for(net.cfg, lm_args)(0)
        res = {}
        for t in (1, TP_T):
            whole, metrics, _, step = one_round(net, full_comp, "allgather_packed", t,
                                                tree_unflatten_like(net, clone(p0)), batch)
            res[t] = (whole, metrics)
            if t > 1 and dtype == "bfloat16":
                tp_state = (whole, step, net)
        a, b = tree_leaves(res[TP_T][0].params), tree_leaves(res[1][0].params)
        moved = sum(int(((y != p) | (x != p)).sum()) for x, y, p in
                    zip(a, b, tree_leaves(p0)))
        differ = sum(int((bits(x) != bits(y)).sum()) for x, y in zip(a, b))
        dloss = res[TP_T][1]["loss"] - res[1][1]["loss"]
        share = differ / max(moved, 1)
        own[dtype] = {"loss_t1": res[1][1]["loss"], "loss_t2": res[TP_T][1]["loss"],
                      "loss_diff": dloss, "updated": moved, "differ": differ, "share": share}
        print(f"[tp] {layers} layers, the model's own gradients in {dtype}: loss T = 1 "
              f"{res[1][1]['loss']:.7f}, T = {TP_T} {res[TP_T][1]['loss']:.7f} (diff "
              f"{dloss:.3g}); {differ} of {moved} updated coordinates differ ({share:.3g})")
        del res, p0, a, b
    out["own_gradients"] = own
    out["float64"] = tp_float64_check(torch, cut, dev, launch.batch_fn_for(cut(), lm_args)(0))
    out["launcher"] = tp_launcher_runs(torch, launch, cut, totals, m, dev)

    # -- checkpoint: saved at T = 2, restored at T = 1
    whole, step, net = tp_state
    with tempfile.TemporaryDirectory() as d:
        state_whole, write = step.checkpoint_state(step.shard_state(whole))
        ckpt.save(d, 1, state_whole)
        like = init_state(net.init(5, dev), server=full_comp.server, seed=7)
        back, _ = ckpt.restore(d, like)
    same = all(torch.equal(bits(x), bits(y)) for x, y in
               zip(tree_leaves(back.params), tree_leaves(whole.params)))
    check(write and same, "tp: the checkpoint saved at T = 2 does not restore at T = 1 "
                          "bit for bit")
    out["checkpoint_t2_to_t1"] = same
    print(f"[tp] checkpoint saved at T = {TP_T} ({layers} layers, bf16) restored at T = 1: "
          f"bit for bit {same}")
    del whole, step, net, back, like, state_whole, tp_state, params
    if dev == "cuda":
        torch.cuda.empty_cache()
    out["families"] = tp_family_runs(torch, one_round, totals, m, dev, family_maps)


#: the elastic runs' participation: dyadic weights (every order of the
#: weighted sums exact) and a report dropout
TP_ELASTIC = {"weights": (1.5, 0.5, 2.0, 1.0), "dropout": 0.25}
#: the share of coordinates that may differ from T = 1 beyond float noise
#: where a float sum over the whole leaf decides (a budget's or a scale's last bit)
TP_FLIP_BOUND = 1e-4


def float_flips(torch, got, want, p0) -> int:
    """Coordinates of two runs' leaves that differ beyond float noise: by
    more than 1e-5 of the leaf's largest update plus two ulps of the value
    in the leaf's dtype (a flipped symbol moves its coordinate by a share of
    a decode unit; a budget or a decode scale an ulp apart by about an ulp
    of the update)."""
    n = 0
    for a, b, p in zip(got, want, p0):
        a32, b32, p32 = a.float(), b.float(), p.float()
        upd = torch.maximum((a32 - p32).abs().max(), (b32 - p32).abs().max())
        eps = torch.finfo(a.dtype).eps
        n += int(((a32 - b32).abs() > 1e-5 * upd + 2 * eps * b32.abs()).sum())
    return n


def tp_round_runs(torch, one_round, net, model, params, batch, totals, m, msgs, leaves,
                  pls) -> dict:
    """The paper's round under the 'model' axis at TP_LAYERS layers, T = 2
    against T = 1 from one state and one batch of injected gradients, with
    every plain version barred: sign and TernGrad on psum (row 4's counter
    map) and the elastic 2-bit gather, bit for bit; sparsign_golomb under
    target_sparsity 0.05 (row 14's map: nnz_dropped 0, wire bytes the slice
    ledger, its bytes beside T = 1's) and 1-bit L2 QSGD with the mean server
    (the decoded psum), each within TP_FLIP_BOUND of T = 1 beyond float
    noise, printed."""
    import numpy as np

    from repro_torch.analysis.drivers import tp_slice_ledger
    from repro_torch.core.algorithm import CompressionConfig
    from repro_torch.core.budgets import BudgetConfig
    from repro_torch.core.compressors import tree_leaves
    from repro_torch.dist.collectives import ParticipationSpec

    runs = (  # label, compression, vote_impl, step options, launches at T = 1 and T = 2, exact
        ("sign psum", CompressionConfig(compressor="sign", server="majority_vote"), "psum", {},
         {1: dict(ternary=leaves * m, vote_update=leaves),
          2: dict(ternary=msgs * m, vote_update=msgs)}, True),
        ("terngrad psum", CompressionConfig(compressor="terngrad", server="mean"), "psum", {},
         {1: dict(ternary=leaves * m), 2: dict(ternary=msgs * m)}, True),
        ("elastic sparsign allgather_packed", CompressionConfig(
            compressor="sparsign", budget=BudgetConfig(value=2.0), server="majority_vote"),
         "allgather_packed", {"participation": ParticipationSpec(**TP_ELASTIC)},
         {1: dict(sparsign_pack2bit=leaves * m, unpack2bit_wsum=leaves,
                  weighted_vote_update=leaves),
          2: dict(sparsign_pack2bit=msgs * m, unpack2bit_wsum=msgs, weighted_vote_update=msgs)},
         True),
        ("sparsign_golomb target_sparsity allgather_packed", CompressionConfig(
            compressor="sparsign_golomb",
            budget=BudgetConfig(kind="target_sparsity", value=GOLOMB_P),
            server="majority_vote"), "allgather_packed", {},
         {1: dict(sparsign_golomb=leaves * m, ungolomb_sum=leaves, vote_update=leaves),
          2: dict(sparsign_golomb=msgs * m, ungolomb_sum=msgs, vote_update=msgs)}, False),
        ("qsgd_1bit_l2 mean allgather_packed", CompressionConfig(
            compressor="qsgd_1bit_l2", server="mean"), "allgather_packed", {},
         {1: dict(ternary=leaves * m), 2: dict(ternary=msgs * m)}, False),
    )
    out = {}
    p0 = tree_leaves(params)
    for label, comp, impl, kw, per_t, exact in runs:
        res, mets = {}, {}
        for t in (1, TP_T):
            whole, metrics, counts, step = one_round(
                net, comp, impl, t, tree_unflatten_like(model, [p.clone() for p in p0]), batch,
                **kw)
            want = expected(**per_t[1 if t == 1 else 2])
            check(counts == want, f"tp round {label} T = {t}: launches {counts}, expected {want}")
            if t > 1:
                for k in totals:
                    totals[k] += counts[k]
                ledger = float(np.float32(tp_slice_ledger(step, net)))
                check(metrics["wire_bytes_per_device"] == ledger,
                      f"tp round {label}: wire bytes {metrics['wire_bytes_per_device']} != the "
                      f"slice ledger {ledger}")
            check(metrics.get("nnz_dropped", 0.0) == 0.0,
                  f"tp round {label} T = {t}: {metrics.get('nnz_dropped')} nonzeros dropped")
            res[t], mets[t] = whole, metrics
            del step
        a, b = tree_leaves(res[TP_T].params), tree_leaves(res[1].params)
        size = sum(x.numel() for x in a)
        differ = sum(int((bits(x) != bits(y)).sum()) for x, y in zip(a, b))
        moved = sum(int(((x != p) | (y != p)).sum()) for x, y, p in zip(a, b, p0))
        flips = float_flips(torch, a, b, p0)
        if exact:
            check(differ == 0, f"tp round {label}: T = {TP_T} differs from T = 1 in {differ} "
                               f"coordinates")
        else:
            check(flips <= TP_FLIP_BOUND * size,
                  f"tp round {label}: {flips} of {size} coordinates differ from T = 1 beyond "
                  f"float noise (bound {TP_FLIP_BOUND})")
        out[label] = {"differ": differ, "flips": flips, "updated": moved, "coords": size,
                      "wire_bytes_t1": mets[1]["wire_bytes_per_device"],
                      "wire_bytes_t2": mets[TP_T]["wire_bytes_per_device"],
                      "nnz_frac_t1": mets[1]["nnz_frac"], "nnz_frac_t2": mets[TP_T]["nnz_frac"],
                      "nnz_dropped": mets[TP_T].get("nnz_dropped")}
        print(f"[tp] {model.cfg.n_layers} layers, injected gradients, {label}: T = {TP_T} "
              f"against T = 1 {differ} of {size} coordinates differ in any bit, {flips} beyond "
              f"float noise (a share {flips / max(moved, 1):.3g} of the {moved} updated); wire "
              f"bytes T = {TP_T} "
              f"{mets[TP_T]['wire_bytes_per_device']:.10g} (the slice ledger), T = 1 "
              f"{mets[1]['wire_bytes_per_device']:.10g}; nnz {mets[TP_T]['nnz_frac']:.6g} "
              f"(T = 1 {mets[1]['nnz_frac']:.6g}), dropped {mets[TP_T].get('nnz_dropped', '-')}")
        del res
    return out


#: the bucketed uplink and the ring under 'model': a capped bucket's payload
#: (several buckets on every wire at TP_LAYERS layers: 7 on the 2-bit gather,
#: 3 on Golomb, 11 on pack8) and the ring's chunk (the trainer's ring runs')
TP_BUCKET_BYTES = 1 << 24
TP_RING_ROWS = 8192
TP_DECODERS = {"pack2": "unpack2bit_sum", "golomb": "ungolomb_sum", "pack8": "unpack8_sum"}


def tp_decode_launches(step, kind: str, m: int, t: int, sizes, pls) -> int:
    """The decode-sum launches of one round of ``step`` (``pls`` None at
    T = 1): a local rank's bucket once (golomb and pack8 once a slot), on the
    ring once a message a chunk (golomb a slot); per leaf, once a slice, or
    on the ring once a message a chunk."""
    wire, plan = step.wire, step.plan
    per_msg = m if getattr(wire, "ring_chunk_rows", None) is not None else 1
    if plan is not None:
        if kind == "pack2":
            return t * per_msg * sum(wire.bucket_ring_chunks(b) for b in plan.buckets)
        return t * per_msg * plan.n_slots
    total = 0
    for i, n in enumerate(sizes):
        sharded = pls is not None and pls[i].sharded
        w = wire.for_slice(n) if sharded else wire
        chunks = w.ring_chunks(n // pls[i].parts if sharded else n) if kind == "pack2" else 1
        total += (t if sharded else 1) * per_msg * chunks
    return total


def tp_bucketed_runs(torch, one_round, net, model, params, batch, totals, m, msgs, leaves,
                     pls, dev="cuda") -> dict:
    """The bucketed uplink and the ring under 'model' at TP_LAYERS layers,
    from one state and one batch of injected gradients, every plain version
    barred: sparsign (fixed B) on the 2-bit gather, sparsign_golomb under
    target_sparsity 0.05 and qsgd8 on pack8, each bucketed in one bucket and
    in TP_BUCKET_BYTES buckets; the first two also on the ring at
    TP_RING_ROWS rows, per leaf and bucketed. Each run at T = 2: its
    launches, its wire bytes == its slice plan's (or slices') ledger,
    nnz_dropped 0, its peak and seconds; held bit for bit against T = 1's
    bucketed run on the 2-bit gather (a fixed budget: every sum exact), and
    where a float sum over the whole leaf decides (the target_sparsity
    bisection, qsgd8's L2 scale) bit for bit against the per-leaf T = 2 run
    and within TP_FLIP_BOUND of T = 1 beyond float noise; every run bit for
    bit against the per-leaf T = 2 run, whose and T = 1's bytes, residency,
    peak, seconds and launches are printed beside."""
    import numpy as np

    from repro_torch.analysis.drivers import tp_slice_ledger
    from repro_torch.core.algorithm import CompressionConfig
    from repro_torch.core.budgets import BudgetConfig
    from repro_torch.core.compressors import tree_leaves

    sizes = [math.prod(sd.shape) for sd in tree_leaves(model.param_shapes())]
    cap = TP_BUCKET_BYTES if dev == "cuda" else 2048
    rows = TP_RING_ROWS if dev == "cuda" else 32
    ring = {"ring_chunk_rows": rows}
    variants = (("bucketed", {"bucketed": True}),
                ("capped", {"bucketed": True, "bucket_bytes": cap}),
                ("ring", ring), ("bucketed ring", dict(ring, bucketed=True)))
    families = (  # label, compression, decode kind, encoder, server kernel, exact, variants
        ("sparsign allgather_packed", CompressionConfig(
            compressor="sparsign", budget=BudgetConfig(value=2.0), server="majority_vote"),
         "pack2", "sparsign_pack2bit", "vote_update", True, variants),
        ("sparsign_golomb target_sparsity", CompressionConfig(
            compressor="sparsign_golomb",
            budget=BudgetConfig(kind="target_sparsity", value=GOLOMB_P),
            server="majority_vote"), "golomb", "sparsign_golomb", "vote_update", False,
         variants),
        ("qsgd8 pack8", CompressionConfig(compressor="qsgd8", server="mean"), "pack8",
         "qsgd8_pack8", None, False, variants[:2]))
    p0 = tree_leaves(params)
    out = {}

    def run(label, comp, kind, enc, srv, t, kw):
        reset_peak(torch)
        t0 = time.perf_counter()
        whole, metrics, counts, step = one_round(
            net, comp, "allgather_packed", t, tree_unflatten_like(model, [p.clone() for p in p0]),
            batch, **kw)
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else 0.0
        n_msgs = msgs if t > 1 else leaves
        want = {enc: n_msgs * m, TP_DECODERS[kind]: tp_decode_launches(
            step, kind, m, t, sizes, pls if t > 1 else None)}
        if srv:
            want[srv] = n_msgs
        check(counts == expected(**want),
              f"tp {label} T = {t}: launches {counts}, expected {expected(**want)}")
        if t > 1:
            for k in totals:
                totals[k] += counts[k]
            ledger = float(np.float32(tp_slice_ledger(step, net)))
            check(metrics["wire_bytes_per_device"] == ledger,
                  f"tp {label}: wire bytes {metrics['wire_bytes_per_device']} != the slice "
                  f"ledger {ledger}")
        check(metrics.get("nnz_dropped", 0.0) == 0.0,
              f"tp {label} T = {t}: {metrics.get('nnz_dropped')} nonzeros dropped")
        res = {"seconds": sec, "peak_gb": peak, "buckets": (len(step.plan.buckets)
                                                            if step.plan is not None else None),
               "wire_bytes": metrics["wire_bytes_per_device"],
               "gather_hbm_bytes": metrics["gather_hbm_bytes"],
               "nnz_frac": metrics["nnz_frac"], "nnz_dropped": metrics.get("nnz_dropped"),
               "launches": {k: v for k, v in counts.items() if v}}
        return tree_leaves(whole.params), res

    def line(res) -> str:
        return (f"{res['buckets'] or 'no'} buckets, gather_hbm_bytes "
                f"{res['gather_hbm_bytes']:.10g}, nnz {res['nnz_frac']:.6g}, dropped "
                f"{res['nnz_dropped']}, peak {res['peak_gb']:.2f} GB, {res['seconds']:.3f} s, "
                f"launches {res['launches']}")

    for label, comp, kind, enc, srv, exact, runs in families:
        refs = {1: run(f"{label} bucketed", comp, kind, enc, srv, 1, {"bucketed": True}),
                TP_T: run(f"{label} per leaf", comp, kind, enc, srv, TP_T, {})}
        for t, what in ((1, "T = 1 bucketed"), (TP_T, f"T = {TP_T} per leaf")):
            out[f"{label} reference {what}"] = refs[t][1]
            print(f"[tp] {model.cfg.n_layers} layers, injected gradients, {label}, the "
                  f"reference {what}: wire bytes {refs[t][1]['wire_bytes']:.10g}, "
                  f"{line(refs[t][1])}")
        for vlabel, kw in runs:
            name = f"{label} {vlabel}"
            got, res = run(name, comp, kind, enc, srv, TP_T, kw)
            size = sum(x.numel() for x in got)
            res["differ_t1"] = sum(int((bits(x) != bits(y)).sum())
                                   for x, y in zip(got, refs[1][0]))
            res["flips_t1"] = float_flips(torch, got, refs[1][0], p0)
            res["differ_per_leaf"] = sum(int((bits(x) != bits(y)).sum())
                                         for x, y in zip(got, refs[TP_T][0]))
            check(res["differ_per_leaf"] == 0, f"tp {name}: differs from the per-leaf T = "
                                               f"{TP_T} run in {res['differ_per_leaf']} "
                                               f"coordinates")
            if exact:
                check(res["differ_t1"] == 0, f"tp {name}: T = {TP_T} differs from T = 1 in "
                                             f"{res['differ_t1']} coordinates")
            else:
                check(res["flips_t1"] <= TP_FLIP_BOUND * size,
                      f"tp {name}: {res['flips_t1']} of {size} coordinates differ from T = 1 "
                      f"beyond float noise (bound {TP_FLIP_BOUND})")
            res.update(coords=size, wire_bytes_per_leaf_t2=refs[TP_T][1]["wire_bytes"],
                       wire_bytes_t1=refs[1][1]["wire_bytes"])
            out[name] = res
            print(f"[tp] {model.cfg.n_layers} layers, injected gradients, {name}: T = {TP_T} "
                  f"against T = 1 {res['differ_t1']} of {size} coordinates differ in any bit, "
                  f"{res['flips_t1']} beyond float noise, against the per-leaf T = {TP_T} run "
                  f"{res['differ_per_leaf']}; wire bytes {res['wire_bytes']:.10g} (the slice "
                  f"plan's ledger; per leaf {res['wire_bytes_per_leaf_t2']:.10g}, T = 1 "
                  f"{res['wire_bytes_t1']:.10g}), {line(res)}")
            del got
        del refs
    return out


def tp_launcher_runs(torch, launch, cut, totals, m, dev="cuda") -> dict:
    """``launch.train --host-model 2`` with ``--bucketed --bucket-bytes`` and
    with ``--ring``, one step each at TP_LAYERS layers (the launcher's
    ``get_config`` patched to the cut config), sparsign l2_norm 0.1 with
    majority vote on allgather_packed, every plain version barred: launches,
    wire bytes == the slice ledger, loss, peak and seconds."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.analysis.drivers import tp_slice_ledger
    from repro_torch.core.compressors import tree_leaves
    from repro_torch.train import loop

    where = (["--full", "--seq-len", str(TRAINER_SEQ_LEN)] if dev == "cuda"
             else ["--device", dev, "--seq-len", "64"])
    cap = TP_BUCKET_BYTES if dev == "cuda" else 2048
    rows = TP_RING_ROWS if dev == "cuda" else 32
    get_config = launch.get_config
    launch.get_config = lambda arch, smoke=True: cut()
    out = {}
    try:
        for label, flags in (("--bucketed", ["--bucketed", "--bucket-bytes", str(cap)]),
                             ("--ring", ["--ring", "--ring-chunk-rows", str(rows)])):
            args = launch.parser().parse_args(
                ["--arch", "qwen1.5-4b", "--host-data", str(m), "--host-model", str(TP_T),
                 "--batch", str(m), "--steps", "1", "--seed", "0", "--compressor", "sparsign",
                 "--budget-kind", "l2_norm", "--budget", "0.1", "--server", "majority_vote",
                 "--vote-impl", "allgather_packed"] + flags + where)
            reset_peak(torch)
            t0 = time.perf_counter()
            cfg, model, group, step, state, comp = launch.build_everything(args)
            sizes = [math.prod(sd.shape) for sd in tree_leaves(model.param_shapes())]
            pls = tree_leaves(step.placements)
            msgs = sum(TP_T if pl.sharded else 1 for pl in pls)
            ledger = float(np.float32(tp_slice_ledger(step, model)))
            kernels.reset_launch_counts()
            with plain_versions_barred():
                state, history = loop.run(step, state, launch.batch_fn_for(cfg, args),
                                          loop.LoopConfig(total_steps=1, log_every=1),
                                          log=lambda line: None)
            sync(torch)
            sec = time.perf_counter() - t0
            counts = kernels.launch_counts()
            want = expected(sparsign_pack2bit=msgs * m, vote_update=msgs,
                            unpack2bit_sum=tp_decode_launches(step, "pack2", m, TP_T, sizes,
                                                              pls))
            check(counts == want, f"tp launcher {label}: launches {counts}, expected {want}")
            for k in totals:
                totals[k] += counts[k]
            h = history[-1]
            check(math.isfinite(h["loss"]), f"tp launcher {label}: non-finite loss {h['loss']}")
            check(h["wire_bytes_per_device"] == ledger,
                  f"tp launcher {label}: wire bytes {h['wire_bytes_per_device']} != the slice "
                  f"ledger {ledger}")
            peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else 0.0
            out[label] = {"loss": h["loss"], "nnz_frac": h["nnz_frac"],
                          "wire_bytes_per_device": ledger,
                          "gather_hbm_bytes": h["gather_hbm_bytes"],
                          "buckets": len(step.plan.buckets) if step.plan is not None else None,
                          "seconds": sec, "step_s": h["wall_s"], "peak_gb": peak,
                          "launches": {k: v for k, v in counts.items() if v}}
            print(f"[tp] launcher {' '.join(flags)} at {cfg.n_layers} layers, M = {m} x T = "
                  f"{TP_T}, one step: loss {h['loss']:.6f}, nnz {h['nnz_frac']:.6g}, wire bytes "
                  f"{ledger:.10g} (== the slice ledger), gather_hbm_bytes "
                  f"{h['gather_hbm_bytes']:.10g}, {out[label]['buckets'] or 'no'} buckets, peak "
                  f"{peak:.2f} GB, {sec:.3f} s with the build (step {h['wall_s']:.3f} s), "
                  f"launches {out[label]['launches']}")
            del step, state, model
    finally:
        launch.get_config = get_config
    return out


def tp_float64_check(torch, cut, dev, batch, tag="tp", floor=1e-7) -> dict:
    """Worker 0's gradients in float32 at T = 1 and at T = 2 (gathered), each
    leaf's distance to the float64 gradient of the same weights, relative to
    its norm: T = 2's at most TP_F64_RATIO times T = 1's plus ``floor``. A
    routed model's choices in the runs are compared too (``route_flips``:
    tokens whose top-k experts differ, expert selections that differ)."""
    from repro_torch.core.compressors import tree_leaves, tree_unflatten
    from repro_torch.dist.collectives import ModelGroup
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import tensor_parallel as tpl
    from repro_torch.models.model import Model

    one = {k: torch.as_tensor(v[:1]).to(dev) for k, v in batch.items()}
    routes = []

    def grads(loss_fn, params):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with moe_lib.record_routes() as log:
            loss = loss_fn(tree_unflatten(params, leaves), one)[0]
        routes.append(log)
        return [g.detach() for g in torch.autograd.grad(loss, leaves)]

    net = Model(cut("float32"))
    p32 = net.init(3, dev)
    g1 = grads(net.loss, p32)
    mg = ModelGroup(TP_T)
    tpm = net.tensor_parallel(mg)
    g2 = tree_leaves(tpl.gather_tree(tree_unflatten(p32, grads(
        tpm.loss, tpl.shard_tree(p32, tpm.placements, mg))), tpm.placements, mg))
    p64 = tree_unflatten(p32, [p.double() for p in tree_leaves(p32)])
    del p32
    g64 = grads(Model(cut("float64")).loss, p64)
    del p64
    e1 = [float((a.double() - c).norm() / c.norm()) for a, c in zip(g1, g64)]
    e2 = [float((b.double() - c).norm() / c.norm()) for b, c in zip(g2, g64)]
    t2_t1 = [float((b - a).norm() / a.norm()) for a, b in zip(g1, g2)]
    bound = [TP_F64_RATIO * a + floor for a in e1]
    worse = [i for i, (b, lim) in enumerate(zip(e2, bound)) if b > lim]
    names = ["t2_vs_t1", "t1_vs_f64", "t2_vs_f64"]
    flips = ({k: moe_lib.route_flips(routes[a], routes[b])
              for k, (a, b) in zip(names, [(0, 1), (0, 2), (1, 2)])} if routes[0] else None)
    ratios = [b / a for a, b in zip(e1, e2)]
    print(f"[{tag}] float32 gradients against float64 (worker 0, {net.cfg.n_layers} layers): "
          f"T = 1 {min(e1):.3g}-{max(e1):.3g} of a leaf's norm, T = {TP_T} "
          f"{min(e2):.3g}-{max(e2):.3g}; T = {TP_T} against T = 1 "
          f"{min(t2_t1):.3g}-{max(t2_t1):.3g}; each leaf's T = {TP_T} / T = 1 distance ratio "
          f"{min(ratios):.3g}-{max(ratios):.3g}"
          + f"; leaves farther than {TP_F64_RATIO} x T = 1's: {worse}"
          + (f"; routing flips (tokens, selections) "
             + ", ".join(f"{k} {tuple(v.values())}" for k, v in flips.items()) if flips else ""))
    check(not worse, f"{tag} float32: leaves {worse} lie farther from float64 at T = {TP_T} "
                     f"({[e2[i] for i in worse]}) than {TP_F64_RATIO} x T = 1's "
                     f"({[e1[i] for i in worse]}) plus {floor}")
    return {"t1_err": e1, "t2_err": e2, "t2_vs_t1": t2_t1, "bound": bound,
            "route_flips": flips}


#: the families this slice puts on 'model' (PERF.md section 4: [tp moe] and
#: [tp mamba2]) and the depth each trains at: qwen2-moe-a2.7b at its zoo cut,
#: 2 of 24 layers (ZOO_LAYERS), mamba2-370m at its whole 48
TP_FAMILY_LAYERS = {"qwen2-moe-a2.7b": 2, "mamba2-370m": 48}
#: the depth of each family's float64 check: mamba2-370m's at TP_LAYERS, as
#: qwen1.5-4b's. At its 48 layers float32's own rounding decides the ratio:
#: on an H100 80GB HBM3 at 700 W final_norm lay 2.93e-4 (T = 1) and 4.79e-4
#: (T = 2) from float64, a ratio of 1.63; on a CPU (d_model 256, 48 layers, two
#: seeds) the ratio ran 0.66-1.22 at T = 2 and 0.46-1.06 at T = 4, alike on
#: every leaf (PERF.md, section 6)
TP_FAMILY_F64_LAYERS = {"qwen2-moe-a2.7b": 2, "mamba2-370m": TP_LAYERS}
TP_FAMILY_TAG = {"qwen2-moe-a2.7b": "tp moe", "mamba2-370m": "tp mamba2"}
#: rows 6 and 14's counter maps on a cut leaf of each family, model rank 1's
#: slice: (the whole leaf's shape, its cut dim). qwen2-moe-a2.7b's stacked
#: moe_w_gate at 2 layers cut on its experts (a slice of [2, 32, 2048, 1408],
#: 184,549,376 coordinates in two runs), mamba2-370m's conv_x cut on d_inner
#: (192 runs of 1,024 in rows of 2,048)
TP_FAMILY_MAPS = {"qwen2-moe-a2.7b moe_w_gate": ((2, 64, 2048, 1408), 1),
                  "mamba2-370m ssm_conv_x": ((48, 4, 2048), 2)}


def tp_family_maps(torch, dev="cuda", shapes=None) -> dict:
    """Rows 6 (sparsign_pack2bit) and 14 (sparsign_golomb) with the counter
    map of model rank 1's slice of each TP_FAMILY_MAPS leaf in bf16, bit for
    bit against their plain versions on the same slice; row 14 at its leaf's
    capacity drops no nonzero."""
    from repro_torch.dist.sharding import Placement
    from repro_torch.kernels.golomb.ops import sparsign_golomb_op
    from repro_torch.kernels.golomb.ref import sparsign_golomb_ref
    from repro_torch.kernels.sparsign_pack2bit.ops import sparsign_pack2bit_op
    from repro_torch.kernels.sparsign_pack2bit.ref import sparsign_pack2bit_ref
    from repro_torch.models import tensor_parallel as tpl

    gen = torch.Generator(device=dev).manual_seed(27)
    out = {}
    for name, (shape, dim) in (shapes or TP_FAMILY_MAPS).items():
        g = (torch.randn(shape, generator=gen, device=dev) * 0.01).to(torch.bfloat16)
        cmap = tpl.slice_counter_map(shape, Placement(dim, TP_T), 1)
        s = g.chunk(TP_T, dim=dim)[1].contiguous()
        seed, base = 12345, (1 << 32) - 5000
        pairs = {
            "sparsign_pack2bit (row 6)": (
                lambda: sparsign_pack2bit_op(s, 50.0, seed, base, counter_map=cmap),
                lambda: sparsign_pack2bit_ref(s, 50.0, seed, base, counter_map=cmap)),
            "sparsign_golomb (row 14)": (
                lambda: sparsign_golomb_op(s, TP_GOLOMB_BUDGET, seed, base, p=GOLOMB_P,
                                           counter_map=cmap, leaf_n=g.numel()),
                lambda: sparsign_golomb_ref(s, TP_GOLOMB_BUDGET, seed, base, p=GOLOMB_P,
                                            counter_map=cmap, leaf_n=g.numel())),
        }
        res = {}
        for label, (kern, plain) in pairs.items():
            a, b = kern(), plain()
            err = max_abs_err(a, b)
            check(same_bits(a, b), f"tp map {name} {label}: the slice's kernel differs from its "
                                   f"plain version (max |err| {err})")
            dropped = golomb_header(a)[1] if label.startswith("sparsign_golomb") else 0
            check(dropped == 0, f"tp map {name} {label}: {dropped} nonzeros dropped")
            res[label] = {"max_abs_err": err, "coords": s.numel(), "dropped": dropped}
            del a, b
        print(f"[tp] {name} slice {tuple(s.shape)} of {tuple(shape)} (counter map: run "
              f"{cmap[0]}, leaf run {cmap[1]}, offset {cmap[2]}; {s.numel()} coordinates, a "
              f"wrapping base): rows 6 and 14 0 bytes from their plain versions, 0 dropped")
        out[name] = res
        del g, s
    return out


def tp_family_runs(torch, one_round, totals, m, dev="cuda", map_shapes=None) -> dict:
    """The MoE and mamba2 families under 'model' (``[tp moe]``,
    ``[tp mamba2]``): rows 6 and 14's counter maps on their cut leaves
    (``tp_family_maps``), then each family at its TP_FAMILY_LAYERS depth
    (``tp_family``)."""
    out = {"maps": tp_family_maps(torch, dev, map_shapes)}
    for arch, tag in TP_FAMILY_TAG.items():
        out[arch] = tp_family(torch, one_round, arch, tag, totals, m, dev)
    return out


def tp_family(torch, one_round, arch, tag, totals, m, dev="cuda") -> dict:
    """One family at published widths and its TP_FAMILY_LAYERS depth (the
    smoke config on the CPU): a launcher run at M = 4 x T = 2, one 4,096-token
    sequence a worker, two steps of sparsign l2_norm 0.1 with majority vote
    on allgather_packed, every plain version barred (launches counted, wire
    bytes == the slice ledger, step times, peak); for a routed model the
    tokens routed otherwise at T = 2 than at T = 1 on worker 0's sequence from
    the run's first state; injected-gradient rounds from one state, T = 2
    against T = 1: fixed sparsign on psum and on the 2-bit gather bit for
    bit, sparsign_golomb under target_sparsity 0.05 within TP_FLIP_BOUND
    (the bisection's float sums, printed) with no nonzero dropped; worker 0's
    float32 gradients against float64 at TP_FAMILY_F64_LAYERS layers
    (``tp_float64_check``)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.analysis.drivers import tp_slice_ledger
    from repro_torch.core.algorithm import CompressionConfig
    from repro_torch.core.budgets import BudgetConfig
    from repro_torch.core.compressors import tree_leaves
    from repro_torch.dist import collectives
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.model import Model
    from repro_torch.train import loop

    where = (["--full", "--seq-len", str(TRAINER_SEQ_LEN)] if dev == "cuda"
             else ["--device", dev, "--seq-len", "64"])
    get_config = launch.get_config
    base = get_config(arch, smoke=dev != "cuda")
    layers = min(base.n_layers, TP_FAMILY_LAYERS[arch])

    def cut(dtype=None, depth=layers):
        c = dataclasses.replace(base, n_layers=depth)
        return dataclasses.replace(c, dtype=dtype) if dtype else c

    def cut_f64(dtype=None):
        return cut(dtype, min(base.n_layers, TP_FAMILY_F64_LAYERS[arch]))

    out = {}
    args = launch.parser().parse_args(
        ["--arch", arch, "--host-data", str(m), "--host-model", str(TP_T), "--batch", str(m),
         "--steps", "2", "--seed", "0", "--compressor", "sparsign", "--budget-kind", "l2_norm",
         "--budget", "0.1", "--server", "majority_vote", "--vote-impl", "allgather_packed"]
        + where)
    # the earlier runs' states may sit in reference cycles until a collection
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    reset_peak(torch)
    resident = torch.cuda.memory_allocated() / 1e9 if dev == "cuda" else 0.0
    t0 = time.perf_counter()
    launch.get_config = lambda a, smoke=True: cut()
    try:
        cfg, model, group, step, state, comp = launch.build_everything(args)
    finally:
        launch.get_config = get_config
    sync(torch)
    build_s = time.perf_counter() - t0
    pls = tree_leaves(step.placements)
    sizes = [math.prod(sd.shape) for sd in tree_leaves(model.param_shapes())]
    per_device = sum(n // pl.parts if pl.sharded else n for n, pl in zip(sizes, pls))
    replicated = sum(n for n, pl in zip(sizes, pls) if not pl.sharded)
    msgs = sum(TP_T if pl.sharded else 1 for pl in pls)
    ledger = float(np.float32(tp_slice_ledger(step, model)))
    whole_ledger = float(np.float32(sum(collectives.uplink_ledger(step.mode, step.wire, n)
                                        for n in sizes)))
    batch_fn = launch.batch_fn_for(cfg, args)
    flips = None
    if cfg.n_experts:   # routing at T = 2 against T = 1, worker 0, the first state
        one = {k: torch.as_tensor(v[:1]).to(dev) for k, v in batch_fn(0).items()}
        with torch.no_grad():
            with moe_lib.record_routes() as r2:
                step.tp_model.forward_hidden(state.params, one)
            whole = step.whole_state(state).params
            with moe_lib.record_routes() as r1:
                model.forward_hidden(whole, one)
            del whole, one
        flips = moe_lib.route_flips(r1, r2)
        flips["routed_tokens"] = cfg.n_layers * args.seq_len
        flips["expert_selections"] = cfg.n_layers * cfg.n_experts_padded
        del r1, r2
    kernels.reset_launch_counts()
    with plain_versions_barred():
        state, history = loop.run(step, state, batch_fn,
                                  loop.LoopConfig(total_steps=2, log_every=1),
                                  log=lambda line: None)
    sync(torch)
    counts = kernels.launch_counts()
    want = expected(sparsign_pack2bit=msgs * m * 2, unpack2bit_sum=msgs * 2,
                    vote_update=msgs * 2)
    check(counts == want, f"{tag}: launches {counts}, expected {want}")
    for k in totals:
        totals[k] += counts[k]
    walls = [h["wall_s"] for h in history]
    step_s = [b - a for a, b in zip([0.0] + walls[:-1], walls)]
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else 0.0
    for h in history:
        check(math.isfinite(h["loss"]), f"{tag}: non-finite loss {h['loss']}")
        check(h["wire_bytes_per_device"] == ledger,
              f"{tag}: wire bytes {h['wire_bytes_per_device']} != the slice ledger {ledger}")
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params)),
          f"{tag}: non-finite parameters")
    out["launcher"] = {"layers": cfg.n_layers, "workers": m, "model_ranks": TP_T,
                       "tokens_per_worker": args.seq_len, "parameters": sum(sizes),
                       "coordinates_a_device": per_device, "replicated": replicated,
                       "messages_a_worker": msgs, "build_s": build_s, "step_s": step_s,
                       "resident_gb": resident, "peak_gb": peak,
                       "loss": [h["loss"] for h in history],
                       "nnz_frac": [h["nnz_frac"] for h in history],
                       "nnz_dropped": [h.get("nnz_dropped") for h in history],
                       "wire_bytes_per_device": ledger, "whole_leaf_ledger": whole_ledger,
                       "route_flips": flips, "launches": counts}
    print(f"[{tag}] {cfg.name} {cfg.n_layers} layers at d_model {cfg.d_model}, M = {m} x "
          f"T = {TP_T} ({sum(sizes)} parameters, {per_device} coordinates a device of which "
          f"{replicated} replicated, {msgs} messages a worker), {args.seq_len} tokens a worker: "
          f"build {build_s:.2f} s, steps {[round(x, 3) for x in step_s]} s, peak {peak:.2f} GB "
          f"({resident:.2f} GB resident before the build), "
          f"losses {[round(h['loss'], 6) for h in history]}, nnz "
          f"{[round(h['nnz_frac'], 6) for h in history]}, wire bytes {ledger:.10g} (== the "
          f"slice ledger; whole leaves {whole_ledger:.10g}), nnz_dropped "
          f"{[h.get('nnz_dropped', '-') for h in history]} (the 2-bit wire drops none), "
          + (f"routing flips T = {TP_T} against T = 1: {flips['tokens']} of "
             f"{flips['routed_tokens']} tokens' top-{cfg.top_k} sets, {flips['selections']} "
             f"of {flips['expert_selections']} experts' capacity selections, " if flips else "")
          + f"launches { {k: v for k, v in counts.items() if v} }")
    del step, state, model, history
    if dev == "cuda":
        torch.cuda.empty_cache()

    # injected gradients: T = 2 against T = 1 from one state and one batch
    model = Model(cut())
    net = InjectedGrads(model)
    leaves = len(tree_leaves(model.param_shapes()))
    pls = tree_leaves(net.tensor_parallel(make_host_mesh(m, TP_T).model).placements)
    msgs = sum(TP_T if pl.sharded else 1 for pl in pls)
    params = model.init(3, dev)
    p0 = tree_leaves(params)
    batch = tp_injected_batch(torch, model, m, 11, dev)
    fixed = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                              server="majority_vote")
    golomb = CompressionConfig(compressor="sparsign_golomb",
                               budget=BudgetConfig(kind="target_sparsity", value=GOLOMB_P),
                               server="majority_vote")
    injected = out["injected"] = {}
    for label, comp, impl, kern, exact in (
            ("fixed psum", fixed, "psum", {"sparsign": 1, "vote_update": 1}, True),
            ("fixed allgather_packed", fixed, "allgather_packed",
             {"sparsign_pack2bit": 1, "unpack2bit_sum": 1, "vote_update": 1}, True),
            ("sparsign_golomb target_sparsity allgather_packed", golomb, "allgather_packed",
             {"sparsign_golomb": 1, "ungolomb_sum": 1, "vote_update": 1}, False)):
        res, mets = {}, {}
        for t, n in ((1, leaves), (TP_T, msgs)):
            whole, metrics, counts, step = one_round(
                net, comp, impl, t, tree_unflatten_like(model, [p.clone() for p in p0]), batch)
            want = expected(**{k: n * (m if k.startswith("sparsign") else 1) for k in kern})
            check(counts == want, f"{tag} injected {label} T = {t}: launches {counts}, "
                                  f"expected {want}")
            if t > 1:
                for k in totals:
                    totals[k] += counts[k]
                ledger = float(np.float32(tp_slice_ledger(step, net)))
                check(metrics["wire_bytes_per_device"] == ledger,
                      f"{tag} injected {label}: wire bytes {metrics['wire_bytes_per_device']} "
                      f"!= the slice ledger {ledger}")
            check(metrics.get("nnz_dropped", 0.0) == 0.0,
                  f"{tag} injected {label} T = {t}: {metrics.get('nnz_dropped')} nonzeros "
                  f"dropped")
            res[t], mets[t] = whole, metrics
            del step
        a, b = tree_leaves(res[TP_T].params), tree_leaves(res[1].params)
        size = sum(x.numel() for x in a)
        differ = sum(int((bits(x) != bits(y)).sum()) for x, y in zip(a, b))
        moved = sum(int(((x != p) | (y != p)).sum()) for x, y, p in zip(a, b, p0))
        flipped = float_flips(torch, a, b, p0)
        if exact:
            check(differ == 0, f"{tag} injected {label}: T = {TP_T} differs from T = 1 in "
                               f"{differ} coordinates")
        else:
            check(flipped <= TP_FLIP_BOUND * size,
                  f"{tag} injected {label}: {flipped} of {size} coordinates differ from T = 1 "
                  f"beyond float noise (bound {TP_FLIP_BOUND})")
        injected[label] = {"differ": differ, "flips": flipped, "updated": moved, "coords": size,
                           "wire_bytes_t1": mets[1]["wire_bytes_per_device"],
                           "wire_bytes_t2": mets[TP_T]["wire_bytes_per_device"],
                           "nnz_dropped": mets[TP_T].get("nnz_dropped")}
        print(f"[{tag}] {layers} layers, injected gradients, {label}: T = {TP_T} against T = 1 "
              f"{differ} of {size} coordinates differ in any bit, {flipped} beyond float noise "
              f"({moved} updated); wire bytes T = {TP_T} "
              f"{mets[TP_T]['wire_bytes_per_device']:.10g} (the slice ledger), T = 1 "
              f"{mets[1]['wire_bytes_per_device']:.10g}; nnz_dropped "
              f"{mets[TP_T].get('nnz_dropped', '-')}")
        del res
    del batch, params, p0, net, model
    if dev == "cuda":
        torch.cuda.empty_cache()
    out["float64"] = tp_float64_check(torch, cut_f64, dev, batch_fn(0), tag=tag,
                                      floor=TP_F64_FLOOR)
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def tree_unflatten_like(model, leaves):
    from repro_torch.core.compressors import tree_unflatten
    return tree_unflatten(model.param_shapes(), leaves)


def phase_analysis(torch, report, dev="cuda"):
    """``python -m repro_torch.analysis`` on ``dev`` (its ``main``), its lines
    printed as [analysis]; a nonzero exit fails the run. ``main`` runs it
    before any phase traces with torch.profiler: after some 400,000 traced
    kernels in one process the profiler sees no device activity, and the
    gate's one-launch check reads it (PERF.md §7)."""
    from repro_torch.analysis.__main__ import main as analysis_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = analysis_main(["--device", dev])
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"[analysis] {line}")
    print(f"[analysis] exit {rc}, {seconds:.1f} s on {dev}")
    report["analysis"] = {"exit": rc, "seconds": seconds, "lines": lines}
    check(rc == 0, "the analysis gate failed (the [analysis] lines above)")


def launch_split(torch, fn) -> list:
    """One traced call of ``fn``: its device activities (kernels, memsets,
    copies) by name in order of first appearance, [name, count, us]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    acts = sorted((e.time_range.start, e.name, e.time_range.end - e.time_range.start)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)
    split = {}
    for _, name, us in acts:
        row = split.setdefault(name, [name, 0, 0.0])
        row[1] += 1
        row[2] += us
    return list(split.values())


def split_trees(torch, trees: list, sources: tuple, make_calls, tag: str) -> dict:
    """The loop of the split modes: build ``sources`` from each kernel source
    tree in turn (default: the checkout's; with two, in the order A, B, B, A
    on one card; with more, once each), then time each call of
    ``make_calls()`` with CUDA events and split its device time by launch
    from one traced call. Every tree's outputs must equal the first tree's
    bit for bit. Also keeps each tree's ptxas report and, where cuobjdump
    runs, its SASS census (``sass_census``). Returns the times and splits by
    tree, also written to chiprun_out/<tag>_split.json."""
    from repro_torch.kernels import build

    timer = Timer(torch)
    order = [trees[0], trees[1], trees[1], trees[0]] if len(trees) == 2 else trees
    first, out = {}, {"device": nvidia_smi(), "runs": []}
    for tree in order:
        build.CSRC = pathlib.Path(tree).resolve()
        build._LIBS.clear()
        run = {"csrc": str(tree), "calls": {}, "ptxas": {}, "sass": {}}
        for name in build.build_all(sources):   # the sources this tree compiled anew
            run["ptxas"][name] = ptxas_report(build.BUILD_LOG[name]["log"])
            for line in run["ptxas"][name]:
                print(f"[ptxas] {tree} {name}: {line}")
            run["sass"][name] = sass_census(
                build._lib_path(name),
                ROOT / "chiprun_out" / "sass" / f"{tag}-{len(out['runs'])}-{name}.sass.gz")
        calls = make_calls()
        for key, fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            if key in first:
                check(same_bits(got, first[key]), f"{tag} split {key}: {tree} differs from "
                                                  f"{order[0]}")
            else:
                first[key] = got
            del got
            t = timer(fn, reps=20)
            split = launch_split(torch, fn)
            run["calls"][key] = {**t, "split": split}
            print(f"[split] {tree} {key}: {t['ms']:.4f} ms (quartiles {t['p25']:.4f}-"
                  f"{t['p75']:.4f}); traced: " + "; ".join(
                      f"{name[:70]} x{n} {us / 1e3:.4f} ms" for name, n, us in split))
        out["runs"].append(run)
        del calls
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"{tag}_split.json").write_text(json.dumps(out, indent=1))
    return out


def ptxas_report(log: str) -> list:
    """nvcc -Xptxas -v's report as one line a kernel: its (mangled) name,
    registers, stack frame and spills."""
    lines, fn, props = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif "stack frame" in line:
            props = line.strip()
        elif "registers" in line and fn:
            lines.append(f"{fn[:90]}: {line.split(':', 1)[-1].strip()}; {props}")
            fn, props = None, ""
    return lines


def sass_census(lib: pathlib.Path, dump: pathlib.Path) -> dict:
    """``sass_loops`` of cuobjdump -sass of a built library, whose listing
    goes to ``dump`` gzipped; or {"error": ...} where cuobjdump does not run."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        res = subprocess.run([exe, "-sass", str(lib)], capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"error": str(e)}
    if res.returncode != 0:
        return {"error": res.stderr.strip()[-300:]}
    dump.parent.mkdir(parents=True, exist_ok=True)
    dump.write_bytes(gzip.compress(res.stdout.encode()))
    return sass_loops(res.stdout)


def sass_loops(listing: str) -> dict:
    """{kernel: {"instructions": n, "loops": [{"instructions": n, "by_opcode":
    {...}, "straight": n, "straight_by_opcode": {...}}, ...]}} from a
    cuobjdump -sass listing: each loop is the span from a backward branch's
    target to the branch, so a kernel's instructions a coordinate are its
    main loop's over the coordinates one pass covers. "straight" counts the
    path through the loop that falls through every predicated branch and
    takes every unconditional forward one: where a loop holds two bodies
    behind a branch on a uniform flag (qsgd8_pack8's hoisted division and its
    __fdiv_rn path), the first body's instructions. "hot" counts the path
    from the loop's head to its branch back, over its forward branches, that
    draws the most uniforms in line (I2FP, one a uniform) and, among those,
    has the fewest instructions: where a loop holds rare blocks behind
    predicated branches (the int8 encoder's row crossing, its exact settling
    of undecided coordinates out of line, its row-state fill), the common
    case that skips them.
    ``python3 chip_smoke.py --sass LISTING[.gz]`` prints it for a saved listing."""
    census, fn, ins = {}, None, []

    def by_opcode(ops):
        return dict(sorted(((o, ops.count(o)) for o in set(ops)), key=lambda kv: -kv[1]))

    def straight(head, tail):
        at = {a: k for k, (a, *_) in enumerate(ins)}
        k, ops = at[head], []
        while k < len(ins) and len(ops) <= len(ins):
            addr, op, arg, cond = ins[k]
            ops.append(op)
            target = re.search(r"0x([0-9a-f]+)", arg) if op == "BRA" and not cond else None
            if addr == tail:
                break
            k = at.get(int(target.group(1), 16), k + 1) if (
                target and int(target.group(1), 16) > addr) else k + 1
        return ops

    def hot(head, tail):
        at = {a: k for k, (a, *_) in enumerate(ins)}
        k0, k1 = at[head], at[tail]
        # index: ((-uniforms, instructions) to it, its predecessor)
        best = {k0: ((-(ins[k0][1] == "I2FP"), 1), None)}
        for k in range(k0, k1):
            if k not in best:
                continue
            addr, op, arg, cond = ins[k]
            target = re.search(r"0x([0-9a-f]+)", arg) if op == "BRA" else None
            nxt = []
            if target and addr < int(target.group(1), 16) <= tail:
                nxt.append(at.get(int(target.group(1), 16)))
            if op not in ("EXIT", "RET") and not (op == "BRA" and not cond):
                nxt.append(k + 1)
            for j in nxt:
                if j is None:
                    continue
                (u, n), _ = best[k]
                score = (u - (ins[j][1] == "I2FP"), n + 1)
                if j not in best or score < best[j][0]:
                    best[j] = (score, k)
        path, k = [], k1 if k1 in best else None
        while k is not None:
            path.append(ins[k][1])
            k = best[k][1]
        return path

    def close():
        if fn is None:
            return
        loops = []
        for addr, op, arg, _ in ins:
            target = re.search(r"0x([0-9a-f]+)", arg) if op == "BRA" else None
            if target and int(target.group(1), 16) < addr:
                head = int(target.group(1), 16)
                body = [o for a, o, _, _ in ins if head <= a <= addr]
                path, common = straight(head, addr), hot(head, addr)
                loops.append({"instructions": len(body), "by_opcode": by_opcode(body),
                              "straight": len(path), "straight_by_opcode": by_opcode(path),
                              "hot": len(common), "hot_by_opcode": by_opcode(common)})
        census[fn] = {"instructions": len(ins), "loops": loops}

    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            close()
            fn, ins = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)\S*\s*([^;]*);",
                     line)
        if m and fn:
            ins.append((int(m.group(1), 16), m.group(3), m.group(4), bool(m.group(2))))
    close()
    return census


def golomb_split(torch, trees: list) -> dict:
    """``--golomb-split [CSRC ...]``: the Golomb kernels at w_down (the
    encoders in bf16 and int8, the decode-sums at M = 1, 4 and 20), through
    ``split_trees``."""
    from repro_torch.core.budgets import solve_budget_for_sparsity
    from repro_torch.kernels.golomb import ref as gref
    from repro_torch.kernels.golomb.kernel import (golomb_pack_cuda, sparsign_golomb_cuda,
                                                   ungolomb_sum_cuda, ungolomb_wsum_cuda)
    from repro_torch.kernels.sparsign.kernel import sparsign_cuda

    dev, p = "cuda", GOLOMB_P
    b, rows = gref.rice_b(p), gref.golomb_rows(N_WDOWN, p)
    gen = torch.Generator(device=dev).manual_seed(2)
    g = (torch.randn(N_WDOWN, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    bud = solve_budget_for_sparsity(g, p).reshape(1)
    sd = [torch.full((1,), s, dtype=torch.int64, device=dev) for s in (1, 11, 12, 13)]
    w = {m: torch.rand(m, generator=gen, device=dev) * 2 for m in (1, 4, 20)}
    t0 = []

    def make_calls():
        if not t0:
            t0.append(sparsign_cuda(g, bud, sd[0]))
        coded = [sparsign_golomb_cuda(g, bud, s, b=b, rows=rows) for s in sd]
        coded[2] = torch.zeros_like(coded[0])
        gath = {1: coded[0][None], 4: torch.stack(coded), 20: torch.stack([coded[0]] * 20)}
        calls = {"sparsign_golomb w_down bf16":
                 lambda: sparsign_golomb_cuda(g, bud, sd[0], b=b, rows=rows),
                 "golomb_pack w_down int8": lambda: golomb_pack_cuda(t0[0], b=b, rows=rows)}
        for m in (1, 4, 20):
            calls[f"ungolomb_sum M={m} w_down"] = (
                lambda m=m: ungolomb_sum_cuda(gath[m], N_WDOWN, b=b))
            calls[f"ungolomb_wsum M={m} w_down"] = (
                lambda m=m: ungolomb_wsum_cuda(gath[m], w[m], N_WDOWN, b=b))
        return calls

    return split_trees(torch, trees, ("golomb_encode", "golomb_decode", "sparsign"),
                       make_calls, "golomb")


def pack2_split(torch, trees: list) -> dict:
    """``--pack2-split [CSRC ...]``: the fused 2-bit encoders at w_down in
    bf16, sparsign_pack2bit and ternary_pack2bit in each of its four rules,
    through ``split_trees``."""
    from repro_torch.kernels.sparsign_pack2bit.kernel import sparsign_pack2bit_cuda
    from repro_torch.kernels.ternary.kernel import ternary_pack2bit_cuda
    from repro_torch.kernels.ternary.rules import RULES

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    g = (torch.randn(N_WDOWN, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    seed = torch.full((1,), 12345, dtype=torch.int64, device=dev)
    prm = {rule: torch.full((1,), PACK2_PARAMS[rule], device=dev) for rule in RULES}

    def make_calls():
        calls = {"sparsign_pack2bit w_down bf16":
                 lambda: sparsign_pack2bit_cuda(g, prm["sparsign"], seed)}
        for rule in RULES:
            calls[f"ternary_pack2bit {rule} w_down bf16"] = (
                lambda rule=rule: ternary_pack2bit_cuda(g, prm[rule], seed, rule=rule))
        return calls

    return split_trees(torch, trees, ("sparsign_pack2bit", "ternary"), make_calls, "pack2")


#: the int8 encoders' shapes of --int8-split and phase 2's w_down timings: one
#: row of w_down, one row of lm_head's vocabulary slice at T = 2 (2,560 x
#: 75,968), and the FL rounds' worker rows
LM_SLICE_N = 2560 * 75968
INT8_FL_SHAPES = {"sparsign": (100, D_CNN), "ternary": (50, D_MLP)}


def int8_split(torch, trees: list) -> dict:
    """``--int8-split [CSRC ...]``: rows 1 (sparsign) and 4 (ternary, every
    rule) at w_down and at LM_SLICE_N contiguous coordinates in bf16 and at
    the FL shapes in float32, and row 5 (every rule) at w_down, through
    ``split_trees``."""
    from repro_torch.kernels.sparsign.kernel import sparsign_cuda
    from repro_torch.kernels.ternary.kernel import ternary_cuda, ternary_pack2bit_cuda
    from repro_torch.kernels.ternary.rules import RULES

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(27)
    g = (torch.randn(N_WDOWN, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    seed = torch.full((1,), 12345, dtype=torch.int64, device=dev)
    prm = {rule: torch.full((1,), PACK2_PARAMS[rule], device=dev) for rule in RULES}
    fl = {k: torch.randn(shape, generator=gen, device=dev) * 0.01
          for k, shape in INT8_FL_SHAPES.items()}
    fl_seeds = {k: torch.arange(shape[0], device=dev) * 7919
                for k, shape in INT8_FL_SHAPES.items()}
    fl_prm = torch.rand(INT8_FL_SHAPES["ternary"][0], generator=gen, device=dev) * 0.05 + 0.005

    def make_calls():
        calls = {}
        for label, x in (("w_down", g), ("lm_head slice", g[:LM_SLICE_N])):
            calls[f"sparsign {label} bf16"] = (
                lambda x=x: sparsign_cuda(x, prm["sparsign"], seed))
            for rule in RULES:
                calls[f"ternary {rule} {label} bf16"] = (
                    lambda x=x, rule=rule: ternary_cuda(x, prm[rule], seed, rule=rule))
        rows, n = INT8_FL_SHAPES["sparsign"]
        calls[f"sparsign {rows}x{n} f32"] = lambda: sparsign_cuda(
            fl["sparsign"], torch.ones(1, device=dev), fl_seeds["sparsign"])
        rows, n = INT8_FL_SHAPES["ternary"]
        for rule in RULES:
            calls[f"ternary {rule} {rows}x{n} f32"] = (
                lambda rule=rule: ternary_cuda(fl["ternary"], fl_prm, fl_seeds["ternary"],
                                               rule=rule))
        for rule in RULES:
            calls[f"ternary_pack2bit {rule} w_down bf16"] = (
                lambda rule=rule: ternary_pack2bit_cuda(g, prm[rule], seed, rule=rule))
        return calls

    return split_trees(torch, trees, ("sparsign", "ternary"), make_calls, "int8")


def pack8_split(torch, trees: list) -> dict:
    """``--pack8-split [CSRC ...]``: qsgd8_pack8 at w_down in bf16 and
    float32 at a trainer-like scale (the hoisted division), and in bf16 at
    scale 3 (__fdiv_rn per coordinate), through ``split_trees``."""
    from repro_torch.core.compressors import qsgd8_scale
    from repro_torch.kernels.pack8.kernel import qsgd8_pack8_cuda

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(8)
    g32 = torch.randn(N_WDOWN, generator=gen, device=dev) * 1e-3
    g16 = g32.to(torch.bfloat16)
    s16, s32 = qsgd8_scale(g16).reshape(1), qsgd8_scale(g32).reshape(1)
    three = torch.full((1,), 3.0, device=dev)
    seed = torch.full((1,), 12345, dtype=torch.int64, device=dev)

    def make_calls():
        return {"qsgd8_pack8 w_down bf16": lambda: qsgd8_pack8_cuda(g16, s16, seed),
                "qsgd8_pack8 w_down f32": lambda: qsgd8_pack8_cuda(g32, s32, seed),
                "qsgd8_pack8 w_down bf16 scale 3": lambda: qsgd8_pack8_cuda(g16, three, seed)}

    return split_trees(torch, trees, ("pack8",), make_calls, "pack8")


def decode_split(torch, trees: list) -> dict:
    """``--decode-split [CSRC ...]``: the decode-sums' monolithic forms (a new
    int32 or float32 sum, the only forms every tree has) at w_down, each at
    M = 1 and 4, through ``split_trees``. Each tree's libraries are called
    through their own C interface: ``*_into_launch`` with accumulate 0 where
    the tree has it, else the earlier ``*_launch``."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.common import canonical_rows

    dev, rows = "cuda", canonical_rows(N_WDOWN)
    gen = torch.Generator(device=dev).manual_seed(3)
    p4 = torch.randint(0, 256, (4, rows, 128), generator=gen, device=dev, dtype=torch.uint8)
    w4 = torch.rand(4, generator=gen, device=dev) * 2
    lv = torch.randint(-127, 128, (4, rows, 512), generator=gen, device=dev, dtype=torch.int8)
    sc = torch.rand(4, generator=gen, device=dev) * 0.01
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    # (library, entry point, argument types) by kernel, for each C interface;
    # the interface with out= and accumulate= also takes the 2-bit sum's
    # output element size
    into = {"unpack2bit_sum": ("unpack2bit", "unpack2bit_sum_into_launch",
                               [vp, vp, i32, i64, i32, i32, vp]),
            "unpack2bit_wsum": ("unpack2bit", "unpack2bit_wsum_into_launch",
                                [vp, vp, vp, i32, i64, i32, vp]),
            "unpack8_sum": ("pack8", "unpack8_sum_into_launch", [vp, vp, vp, i32, i64, i32, vp])}
    earlier = {"unpack2bit_sum": ("unpack2bit", "unpack2bit_sum_launch", [vp, vp, i32, i64, vp]),
               "unpack2bit_wsum": ("unpack2bit", "unpack2bit_wsum_launch",
                                   [vp, vp, vp, i32, i64, vp]),
               "unpack8_sum": ("pack8", "unpack8_sum_launch", [vp, vp, vp, i32, i64, vp])}

    def make_calls():
        libs = {name: ctypes.CDLL(str(build._lib_path(name))) for name in ("unpack2bit", "pack8")}
        new = hasattr(libs["unpack2bit"], "unpack2bit_sum_into_launch")
        fns = {}
        for kind, (lib, sym, argtypes) in (into if new else earlier).items():
            fns[kind] = getattr(libs[lib], sym)
            fns[kind].argtypes, fns[kind].restype = argtypes, ctypes.c_int

        def run(kind, ptrs, m, dtype):
            out = torch.empty((rows, 512), dtype=dtype, device=dev)
            args = [*ptrs, out.data_ptr(), m, rows]
            if new:   # int32 out, not accumulating
                args += [4, 0] if kind == "unpack2bit_sum" else [0]
            err = fns[kind](*args, torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"{kind} failed to launch: cudaError {err}")
            return out

        return {"unpack2bit_sum M=1 w_down":
                lambda: run("unpack2bit_sum", [p4.data_ptr()], 1, torch.int32),
                "unpack2bit_sum M=4 w_down":
                lambda: run("unpack2bit_sum", [p4.data_ptr()], 4, torch.int32),
                "unpack2bit_wsum M=1 w_down":
                lambda: run("unpack2bit_wsum", [p4.data_ptr(), w4.data_ptr()], 1, torch.float32),
                "unpack2bit_wsum M=4 w_down":
                lambda: run("unpack2bit_wsum", [p4.data_ptr(), w4.data_ptr()], 4, torch.float32),
                "unpack8_sum M=1 w_down":
                lambda: run("unpack8_sum", [lv[:1].data_ptr(), sc.data_ptr()], 1, torch.float32),
                "unpack8_sum M=4 w_down":
                lambda: run("unpack8_sum", [lv.data_ptr(), sc.data_ptr()], 4, torch.float32)}

    return split_trees(torch, trees, ("unpack2bit", "pack8"), make_calls, "decode")


def main() -> int:
    t_start = time.perf_counter()
    if "--train-child" in sys.argv:   # a fresh process for the mamba2 restart
        return train_child(sys.argv[sys.argv.index("--train-child") + 1:])
    if "--sass" in sys.argv:   # a saved listing (--pack2-split's): no card
        path = pathlib.Path(sys.argv[sys.argv.index("--sass") + 1])
        data = path.read_bytes()
        text = (gzip.decompress(data) if path.suffix == ".gz" else data).decode()
        for fn, c in sass_loops(text).items():
            print(f"{fn}: {c['instructions']} instructions")
            for loop in c["loops"]:
                print(f"  loop of {loop['instructions']}: {loop['by_opcode']}")
                if loop["straight"] != loop["instructions"]:
                    print(f"    straight path {loop['straight']}: {loop['straight_by_opcode']}")
                if loop["hot"] != loop["straight"]:
                    print(f"    hot path {loop['hot']}: {loop['hot_by_opcode']}")
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    for flag, split in (("--golomb-split", golomb_split), ("--pack2-split", pack2_split),
                        ("--pack8-split", pack8_split), ("--decode-split", decode_split),
                        ("--int8-split", int8_split)):
        if flag in sys.argv:
            trees = sys.argv[sys.argv.index(flag) + 1:] or [
                str(ROOT / "src" / "repro_torch" / "csrc")]
            print(nvidia_smi())
            split(torch, trees)
            return 0
    from repro_torch import kernels
    from repro_torch.kernels import build

    smi = nvidia_smi()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    built = build.build_all()
    for name in build.SOURCES:
        build.library(name)
    build_s = time.perf_counter() - t0
    print(f"[build] {build_s:.2f} s wall; per source {built}")
    for name, entry in build.BUILD_LOG.items():
        for line in ptxas_report(entry["log"]):
            print(f"[build] {name}: {line}")

    report = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build": {"wall_s": build_s, "per_source_s": built}}
    phase_s = report["phase_s"] = {}   # host seconds of each phase, in order

    def run_phase(fn, *args):
        t0 = time.perf_counter()
        out = fn(torch, *args)
        phase_s[fn.__name__] = time.perf_counter() - t0
        return out

    timer = Timer(torch)
    errs, main_times = run_phase(phase_kernels, timer, report)
    for k, v in run_phase(phase_int8, timer, report)[0].items():
        errs[k] = max(errs[k], v)
    for fn in (phase_wire_kernels, phase_golomb_kernels, phase_pack8_kernels):
        more_errs, more_times = run_phase(fn, timer, report)
        errs.update(more_errs)
        main_times.update(more_times)
    del timer
    torch.cuda.empty_cache()
    run_phase(phase_analysis, report)
    totals = {k: 0 for k in kernels.launch_counts()}
    run_phase(phase_tp, report, totals)
    for k, v in run_phase(phase_fl, report).items():
        totals[k] += v
    run_phase(phase_baselines, report, totals)
    run_phase(phase_golomb_two_pass, report, totals)
    timer = Timer(torch)
    run_phase(phase_ring, timer, report)
    del timer
    torch.cuda.empty_cache()
    for fn in (phase_trainer, phase_zoo, phase_mamba_trainer, phase_serve,
               phase_mamba_serve, phase_zoo_serve, phase_streamed, phase_jamba):
        run_phase(fn, report, totals)
    print("[done] phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()))
    check(all(totals[k] > 0 for k in totals), f"a kernel never launched on the path: {totals}")

    rows = []
    for name in REPLACES:
        t = main_times[name]
        rows.append({"name": name, "route": "cuda", "source": SOURCE[name],
                     "replaces": REPLACES[name], "launches": totals[name],
                     "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    # the counter-map launches of rows 4 and 14 (a model rank's slice), timed
    # on lm_head's vocabulary slice, their launches those of phase_tp's runs
    slices = report["tp"]["slices"]
    for name, label in TP_NEW_MAPS.items():
        t = slices["lm_head"][label]
        rows.append({"name": f"{name} (counter map)", "route": "cuda", "source": SOURCE[name],
                     "replaces": REPLACES[name],
                     "launches": report["tp"]["map_launches"][name],
                     "max_abs_err": max(slices[k][label]["max_abs_err"]
                                        for k in TP_SLICE_SHAPES),
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None})
    report["kernels"] = rows
    report["wall_s"] = time.perf_counter() - t_start
    print(f"[done] {report['wall_s']:.1f} s wall")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
