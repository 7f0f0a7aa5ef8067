"""The paper's whole round under the tensor-parallel 'model' axis, on the
CPU: every (compressor, wire, budget, server) that the T = 1 step builds,
enumerated from the registries, builds and runs at (4 workers, 2 model
ranks) and lands within the float-sum flip bound of T = 1; and the counter
maps of the flat ternary encoder (row 4) and the fused Golomb encoder (row
14), whose plain versions on a model rank's slice equal the whole leaf's
on the slice's coordinates.
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BUDGET_KINDS, BudgetConfig
from repro_torch.core.compressors import SPECS, tree_leaves
from repro_torch.core.engine import SERVER_RULES
from repro_torch.dist.collectives import VOTE_IMPLS
from repro_torch.kernels.golomb.ops import sparsign_golomb_op
from repro_torch.kernels.golomb.ref import (decode_stream, golomb_capacity_nnz, golomb_rows,
                                            rice_b, sparsign_golomb_ref)
from repro_torch.kernels.sparsign.ref import sparsign_ref
from repro_torch.kernels.ternary.ops import ternary_compress_op
from repro_torch.kernels.ternary.ref import ternary_compress_ref
from repro_torch.kernels.ternary.rules import RULES
from test_torch_tp import (HIER_MESH, MESH, InjectedTPModel, _state_of, _t1_step, _tp_injected,
                           _tp_step, f32bits, float_flips, tp_slice_ledger)

BUDGET_VALUES = {"fixed": 1.0, "linf_share": 1.0, "l2_norm": 0.1, "target_sparsity": 0.05}
GOLOMB_P = 0.1   # the golomb wire's plan fraction for the budgets without one


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("compressor", sorted(SPECS))
def test_every_t1_configuration_runs_at_t2(compressor):
    """For every vote wire, budget kind and server rule: if the T = 1 step
    builds, the (4, 2) step builds and runs a round from the same state and
    batch, its wire bytes are the slice ledger, and, where neither side's
    Golomb messages truncate, at most 1e-4 of the coordinates differ from
    T = 1 beyond float noise (the float sums over the whole
    leaf: a budget or a decode scale an ulp apart, ``float_flips``)."""
    params, _, batch = _tp_injected(3)
    size = sum(x.size for x in params)
    ran, worst = [], 0
    for impl, kind, server in itertools.product(VOTE_IMPLS, BUDGET_KINDS, SERVER_RULES):
        tc = CompressionConfig(compressor=compressor,
                               budget=BudgetConfig(kind=kind, value=BUDGET_VALUES[kind]),
                               server=server)
        try:
            t1 = _t1_step(tc, impl, golomb_p=GOLOMB_P)
        except (ValueError, NotImplementedError):
            continue   # the T = 1 step refuses it as well
        t2 = _tp_step(tc, impl, HIER_MESH if impl == "hier" else MESH, golomb_p=GOLOMB_P)
        s1, m1 = t1(_state_of(params, server), batch)
        s2, m2 = t2(t2.shard_state(_state_of(params, server)), batch)
        a = [t.numpy() for t in tree_leaves(t2.whole_state(s2).params)]
        b = [t.numpy() for t in tree_leaves(s1.params)]
        assert all(np.isfinite(x).all() for x in a), (impl, kind, server)
        assert float(m2["wire_bytes_per_device"]) == np.float32(
            tp_slice_ledger(t2, InjectedTPModel())), (impl, kind, server)
        if float(m1.get("nnz_dropped", 0.0)) or float(m2.get("nnz_dropped", 0.0)):
            ran.append((impl, kind, server, "truncated"))
            continue
        flips = float_flips(a, b, params)
        assert flips <= 1e-4 * size, (impl, kind, server, flips)
        worst = max(worst, flips)
        ran.append((impl, kind, server,
                    sum(int((f32bits(x) != f32bits(y)).sum()) for x, y in zip(a, b))))
    print(f"{compressor}: {len(ran)} configurations at (4, 2), at most {worst} coordinates "
          f"beyond float noise from T = 1; (wire, budget, server, bits apart): {ran}")
    assert ran


# ------------------------------------------------------------ the two maps

LEAF_RUN = 504
#: (run, offset) of a slice of each leaf row of LEAF_RUN coordinates: a run
#: of 1, 17 (under the kernels' 16-coordinate groups' run), 252 (half the
#: row), and the full row
MAPS = [(1, 0), (1, 503), (17, 34), (252, 252), (LEAF_RUN, 0)]
BASES = [0, (1 << 32) - 5000]   # the second wraps inside the slice


def _leaf(dtype, seed=0):
    g = torch.from_numpy(np.random.RandomState(seed).randn(12, LEAF_RUN).astype(np.float32))
    g[:, ::37] = 0.0
    return g.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rule", list(RULES))
def test_ternary_map_plain_version_is_the_whole_leafs(rule, dtype):
    """Row 4's plain version with a counter map, and the op on a CPU tensor,
    on a slice of each MAPS run: the whole leaf's symbols at the slice's
    coordinates, at a counter base of 0 and one whose counter wraps inside
    the slice; one row a worker seed (the batched form) as well."""
    g = _leaf(dtype)
    param = {"sparsign": 1.5, "sign": 0.0, "noisy_sign": 0.5, "stochastic_ternary": 2.0}[rule]
    for (run, off), base in itertools.product(MAPS, BASES):
        whole = ternary_compress_ref(g, param, 77, base, rule=rule)
        s = g[:, off:off + run].contiguous()
        cmap = (run, LEAF_RUN, off)
        got = ternary_compress_ref(s, param, 77, base, rule=rule, counter_map=cmap)
        assert torch.equal(got, whole[:, off:off + run]), (run, off, base)
        assert torch.equal(ternary_compress_op(s, param, 77, base, rule=rule, counter_map=cmap),
                           got)
        rows = ternary_compress_ref(torch.stack([s, s]), [param, param], [77, 78], base,
                                    rule=rule, counter_map=cmap)
        assert torch.equal(rows[0], got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_golomb_map_plain_version_is_the_whole_leafs(dtype):
    """Row 14's plain version with a counter map on a slice of each MAPS run:
    its stream decodes to the whole leaf's sparsign symbols at the slice's
    coordinates (gaps and signs in the slice's own), its capacity is the
    slice rule of ``golomb_rows`` (the whole leaf's nonzeros, the slice's
    unary spill), and the op on a CPU tensor gives the same bytes."""
    g = _leaf(dtype, seed=1)
    p, budget = 0.05, 0.05
    for (run, off), base in itertools.product(MAPS, BASES):
        whole = sparsign_ref(g, budget, 91, base)
        s = g[:, off:off + run].contiguous()
        cmap = (run, LEAF_RUN, off)
        coded = sparsign_golomb_ref(s, budget, 91, base, p=p, counter_map=cmap,
                                    leaf_n=g.numel())
        assert coded.shape[0] == golomb_rows(s.numel(), p, g.numel())
        votes = decode_stream(coded, s.numel(), b=rice_b(p)).reshape(s.shape)
        assert torch.equal(votes.to(torch.int8), whole[:, off:off + run]), (run, off, base)
        assert torch.equal(sparsign_golomb_op(s, budget, 91, base, p=p, counter_map=cmap,
                                              leaf_n=g.numel()), coded)


def test_golomb_slice_capacity_is_the_leafs_nonzeros():
    """``golomb_rows(n, p, leaf_n)``: a slice's nonzero capacity is the whole
    leaf's (capped at the slice's coordinates), its unary spill the slice's
    own; a whole leaf (leaf_n = n) is the plain rule."""
    p = 0.05
    for n_leaf, t in ((707_788_800, 2), (40 * 96, 2), (151_936 * 2560, 4)):
        n = n_leaf // t
        assert golomb_rows(n_leaf, p, n_leaf) == golomb_rows(n_leaf, p)
        cap = min(n, golomb_capacity_nnz(n_leaf, p))
        bits = cap * (2 + rice_b(p)) + -(-n // (1 << rice_b(p)))
        assert golomb_rows(n, p, n_leaf) == -(-(8 + -(-bits // 8)) // 128)
        assert golomb_rows(n, p) <= golomb_rows(n, p, n_leaf) < golomb_rows(n_leaf, p) + 1


def test_every_c_entry_point_is_bound_with_its_arity():
    """Each ``extern "C"`` function of ``csrc/*.cu`` is in
    ``build.SIGNATURES`` under its source with one ctypes type a parameter,
    and every entry point a wrapper asks ``build.library`` for is there: a
    missing one (a new map launch) otherwise shows only on the card."""
    import pathlib
    import re

    from repro_torch.kernels import build
    root = pathlib.Path(build.__file__).resolve().parent
    declared = {}
    for src in sorted((root.parent / "csrc").glob("*.cu")):
        for name, params in re.findall(r'extern "C"\s+[\w ]+?\s+\**(\w+)\(([^)]*)\)',
                                       src.read_text()):
            declared[(src.stem, name)] = len([p for p in params.split(",") if p.strip()])
    bound = {(lib, fn): len(types) for lib, fns in build.SIGNATURES.items()
             for fn, types in fns.items()}
    assert declared == bound
    for wrapper in root.glob("*/kernel.py"):
        for lib, entry in re.findall(r'build\.library\("(\w+)"(?:,\s*"(\w+)")?\)',
                                     wrapper.read_text()):
            assert lib in build.SIGNATURES and (not entry or (lib, entry) in bound), \
                (wrapper.parent.name, lib, entry)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_local_scales_of_slices_are_the_whole_leafs(dtype):
    """Every local-norm row (scaled sign's L1 mean, 1-bit QSGD's L2 and
    L-inf, qsgd8's L2) on a leaf's two column slices: the decode scale built
    from the slices' partials (``engine.leaf_slices``) equals the whole
    leaf's, bf16 included (the L1 sum ends in the leaf's dtype, as the whole
    leaf's does), and the slices' symbols are the whole leaf's; gradients in
    multiples of 1/8, so every sum is exact in any order."""
    from repro_torch.core import engine
    from repro_torch.dist.collectives import ModelGroup, tp_max, tp_sum

    mg = ModelGroup(2)
    rng = np.random.RandomState(5)
    g = torch.from_numpy(rng.randint(-16, 17, (48, 96)).astype(np.float32) / 8).to(dtype)
    parts = [g[:, :48].contiguous(), g[:, 48:].contiguous()]
    maps = [(48, 96, 0), (48, 96, 48)]
    rows = [name for name, spec in sorted(SPECS.items()) if spec.scale_protocol == "local_norm"]
    assert rows
    for name in rows:
        cfg = CompressionConfig(compressor=name, server="mean")
        whole = engine.compress_leaf(g, cfg, 9)
        slices = engine.leaf_slices(cfg, parts, maps, g.numel(),
                                    psum=lambda x: tp_sum(x, mg), pmax=lambda x: tp_max(x, mg))
        for r, (x, lsl) in enumerate(zip(parts, slices)):
            msg = engine.compress_leaf(x, cfg, 9, leaf_slice=lsl)
            assert torch.equal(msg.scale, whole.scale), (name, dtype)
            assert torch.equal(msg.values, whole.values[:, 48 * r:48 * (r + 1)]), (name, dtype)
