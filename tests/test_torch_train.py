"""The port's simple-mode data-parallel trainer against the JAX package, on
the CPU:

(a) at M = 1 against JAX's own ``build_train_step`` on a one-device host
    mesh, two steps of the qwen1.5-4b smoke model from the same weights;
(b) at M = 4 with injected gradients (the same numpy gradients on both
    sides) against an explicit per-worker JAX oracle built from the JAX
    package's engine, wire decode and sampling, bit for bit, on the votes,
    scaled-votes, decoded and elastic paths;
(c) the three wires (psum, hier 2 x 2, allgather_packed) give bitwise-equal
    parameters in the port, with and without elastic participation;
(d) tau = 2 local steps against the oracle's Alg. 2 loop.

In (a) the two sides' gradients differ in float rounding (autograd and
``jax.grad`` sum in other orders), so a sparsign draw can land between them
and flip a vote; the count of coordinates that differ is bounded by
``MAX_FLIPS`` and printed (0 of 115,392 in both steps when written). The
EF server's update ``p - lr * scale * sign(acc)`` is not exact: XLA on the
CPU contracts it into a fused multiply-add where torch rounds the product
first (12 of 115,392 coordinates one ulp apart after the first step, with
equal residuals), and from the second step the L1 scale is a float sum in
another order. The EF case is held to rtol 1e-6 with the same coordinates
moving.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from repro.configs.registry import get_config as jget_config
from repro.core import engine as jengine
from repro.core import prng as jprng
from repro.core.algorithm import CompressionConfig as JConfig
from repro.core.budgets import BudgetConfig as JBudget
from repro.dist import collectives as jcoll
from repro.dist import compat as jcompat
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models.model import Model as JModel
from repro.train import sampling as jsampling
from repro.train.state import LrSchedule as JLr
from repro.train.state import init_state as j_init_state
from repro.train.step_simple import TrainStepConfig as JStepConfig
from repro.train.step_simple import build_train_step as j_build
from repro_torch.configs.registry import get_config
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import tree_leaves
from repro_torch.data.synthetic import LMStreamConfig, lm_batch
from repro_torch.dist.collectives import ParticipationSpec
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models.model import Model, ShapeDtype, params_from_numpy
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step

MAX_FLIPS = 4          # coordinates whose vote may flip in (a), of 115,392
METRICS = ("wire_bytes_per_device", "nnz_frac", "participated", "gather_hbm_bytes", "lr")


def f32bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------- (a) M = 1

def _smoke_batch(step, b=2, s=16):
    return lm_batch(LMStreamConfig(vocab_size=256, seq_len=s, global_batch=b, seed=5), step)


@pytest.mark.parametrize("vote_impl,server", [("allgather_packed", "majority_vote"),
                                              ("psum", "scaled_sign_ef")])
def test_m1_matches_jax_build_train_step(vote_impl, server, capsys):
    jm = JModel(jget_config("qwen1.5-4b", smoke=True))
    tm = Model(get_config("qwen1.5-4b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    jcomp = JConfig(compressor="sparsign", budget=JBudget(value=2.0), server=server)
    tcomp = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                              server=server)
    mesh = j_host_mesh(1, 1)
    jstep = j_build(jm, JStepConfig(compression=jcomp, lr=JLr(base=0.05), worker_axes=("data",),
                                    vote_impl=vote_impl, donate=False), mesh)
    tstep = build_train_step(tm, TrainStepConfig(compression=tcomp, lr=LrSchedule(base=0.05),
                                                 vote_impl=vote_impl), make_host_mesh(1))
    # the state on the mesh as the step returns it, so the second step reuses
    # the first one's compilation
    jstate = jax.device_put(j_init_state(jp, server=server, seed=7),
                            NamedSharding(mesh, PartitionSpec()))
    tstate = init_state(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)),
                        server=server, seed=7)
    p0 = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    for step in range(2):
        batch = _smoke_batch(step)
        with jcompat.set_mesh(mesh):
            jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tmet = tstep(tstate, batch)
        for k in METRICS:
            assert f32bits(tmet[k]) == f32bits(jmet[k]), (step, k)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-6)
        jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate.params)]
        tl = [t.numpy() for t in tree_leaves(tstate.params)]
        differ = sum(int((f32bits(a) != f32bits(b)).sum()) for a, b in zip(jl, tl))
        with capsys.disabled():
            print(f"\n[{vote_impl}/{server}] step {step}: {differ} of "
                  f"{sum(a.size for a in jl)} coordinates differ from JAX")
        if server == "majority_vote":
            assert differ <= MAX_FLIPS
        else:   # XLA's fused multiply-add, and the L1 scale's order of sums
            for a, b, p in zip(jl, tl, p0):
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)
                np.testing.assert_array_equal(b != p, a != p)


# ------------------------------------------------ injected gradients, M = 4

SHAPES = {"blocks": ({"a": ShapeDtype((2, 33), torch.float32),
                      "b": ShapeDtype((3, 6001), torch.float32)},),
          "embed": ShapeDtype((50, 8), torch.float32),
          "final_norm": ShapeDtype((8,), torch.float32)}
M = 4


class InjectedModel:
    """loss = sum_i <p_i, g_i> with g_i from the batch: autograd's gradient
    of leaf i is g_i exactly, so both sides compress the same numbers."""

    def param_shapes(self):
        return SHAPES

    def loss(self, params, batch):
        total = sum(torch.sum(p * batch[f"g{i}"][0]) for i, p in enumerate(tree_leaves(params)))
        return total, {"loss": total}


def _injected(seed, tau=1):
    """params and per-step, per-worker gradients as numpy; the gradients as
    the batch the port's trainer splits (axis 0, or 1 behind tau)."""
    rng = np.random.RandomState(seed)
    shapes = [s.shape for s in tree_leaves(SHAPES)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = rng.randn(tau, M, sum(int(np.prod(s)) for s in shapes)).astype(np.float32) * 0.3
    grads[..., ::53] = 0.0
    per = []   # per[c][w][i]
    for c in range(tau):
        off, rows = 0, []
        for s in shapes:
            k = int(np.prod(s))
            rows.append(grads[c, :, off:off + k].reshape((M,) + s))
            off += k
        per.append(rows)
    batch = {f"g{i}": (per[0][i] if tau == 1 else np.stack([per[c][i] for c in range(tau)]))
             for i in range(len(shapes))}
    return params, per, batch


def jax_oracle(params, per, jcomp, *, seed, step, lr, part=None, local_lr=0.0,
               golomb_p=None):
    """One round of the trainer, worker by worker, from the JAX package's
    parts: sampling and seeds, the engine's compress_leaf on the packed wire
    (jnp backend), the wire's decode (int8 total, or the weighted decode),
    and server_apply. ``golomb_p`` puts the messages on the golomb wire at
    that plan fraction instead."""
    wire = (jcoll.GolombWire(axes=("data",), n_workers=M, p=golomb_p) if golomb_p is not None
            else jcoll.PackedVoteWire(axes=("data",), n_workers=M))
    rseed = jsampling.round_seed(jnp.uint32(seed), jnp.int32(step))
    wseeds = [jprng.fold_seed(rseed, 0x5EED) + jnp.uint32(w) * jnp.uint32(0x9E3779B9)
              for w in range(M)]
    mask = [jsampling.participation_mask(rseed, jnp.int32(step), jnp.uint32(w),
                                         jcomp.worker_sample_fraction) for w in range(M)]
    if part is not None:
        mask = [m & jsampling.report_mask(rseed, jnp.int32(step), jnp.uint32(w), part.dropout)
                for w, m in enumerate(mask)]
        wvec = jnp.asarray([part.weights[w] for w in range(M)], jnp.float32) * jnp.asarray(
            mask, jnp.float32)
    tau = jcomp.local_steps
    sources = []   # sources[w][i]: the message source (Alg. 1 gradient or Alg. 2 sum)
    for w in range(M):
        if tau == 1:
            sources.append([jnp.asarray(g[w]) for g in per[0]])
            continue
        local_cfg = jengine.local_step_config(jcomp)
        wl = [jnp.asarray(p) for p in params]
        acc = [jnp.zeros(p.shape, jnp.int32) for p in params]
        for c in range(tau):
            for i, g in enumerate(per[c]):
                q = jengine.compress_leaf(jnp.asarray(g[w]), local_cfg,
                                          jprng.fold_seed(wseeds[w], 7000 + i),
                                          counter_base=c * g[w].size, backend="jnp").values
                wl[i] = wl[i] - local_lr * q.astype(wl[i].dtype)
                acc[i] = acc[i] + q.astype(jnp.int32)
        sources.append([a.astype(jnp.float32) for a in acc])
    n_sel = sum(jnp.asarray(m, jnp.float32) for m in mask)
    mode = jengine.wire_mode(jcomp, vote_impl="allgather_packed")
    out = []
    for i, p in enumerate(params):
        shared = None
        if jengine.needs_shared_linf(jcomp):
            shared = jnp.max(jnp.stack([jnp.where(mask[w], jnp.max(jnp.abs(sources[w][i])), 0.0)
                                        for w in range(M)]))
        pj = jnp.asarray(p)
        if mode == "decoded":   # each worker's own scale: decoded floats, summed in order
            total = None
            for w in range(M):
                msg = jengine.compress_leaf(sources[w][i], jcomp, jprng.fold_seed(wseeds[w], i),
                                            backend="jnp", shared_linf=shared)
                dec = jnp.where(mask[w], msg.values.astype(jnp.float32) * msg.scale, 0.0)
                total = dec if total is None else total + dec
            new, _ = jengine.server_apply(pj, total, jcomp, lr=lr, n_sel=n_sel, server="mean",
                                          backend="jnp")
            out.append(np.asarray(new))
            continue
        msgs = []
        for w in range(M):
            msg = jengine.compress_leaf(sources[w][i], jcomp, jprng.fold_seed(wseeds[w], i),
                                        backend="jnp", wire=wire, shared_linf=shared)
            msgs.append(jnp.where(mask[w], msg.values, jnp.zeros((), jnp.uint8)))
        stack = jnp.stack(msgs)
        if golomb_p is not None:
            decode_sum = _golomb_decode_sum_jit
            decode_wsum = _golomb_decode_wsum_jit
            gkw = {"p": golomb_p}
        else:
            decode_sum, decode_wsum, gkw = jcoll._packed_decode_sum, jcoll._packed_decode_wsum, {}
        if part is not None:
            wv = decode_wsum(stack, wvec, p.size, p.shape, backend="jnp", **gkw)
            new, _ = jengine.server_apply(pj, wv, jcomp, lr=lr, part_total=jnp.sum(wvec),
                                          q_frac=part.resolve_q_frac(1, M), backend="jnp")
        else:
            votes = decode_sum(stack, p.size, p.shape, backend="jnp", **gkw).astype(jnp.int8)
            if mode == "votes":
                new, _ = jengine.server_apply(pj, votes, jcomp, lr=lr, n_sel=n_sel,
                                              backend="jnp")
            else:
                new, _ = jengine.server_apply(pj, votes, jcomp, lr=lr, n_sel=n_sel,
                                              server="mean", scale=msg.scale, backend="jnp")
        out.append(np.asarray(new))
    return out


# the JAX golomb decode is a while loop over codes: compiled once per leaf
_golomb_decode_sum_jit = jax.jit(jcoll._golomb_decode_sum, static_argnums=(1, 2),
                                 static_argnames=("p", "backend"))
_golomb_decode_wsum_jit = jax.jit(jcoll._golomb_decode_wsum, static_argnums=(2, 3),
                                  static_argnames=("p", "backend"))


CASES = {
    "sparsign": dict(compressor="sparsign", budget=2.0, server="majority_vote"),
    "sign": dict(compressor="sign", budget=1.0, server="majority_vote"),
    "terngrad": dict(compressor="terngrad", budget=1.0, server="mean"),
    # a per-worker scale under a mean server: the decoded wire (L-inf norms
    # are exact, so the float32 sum in worker order is the only arithmetic)
    "qsgd_1bit_linf": dict(compressor="qsgd_1bit_linf", budget=1.0, server="mean"),
    "elastic_sparsign": dict(compressor="sparsign", budget=2.0, server="majority_vote",
                             participation=(1.5, 0.5, 2.0, 1.0), dropout=0.25),
}


def _configs(case, tau=1):
    c = dict(CASES[case])
    weights, dropout = c.pop("participation", None), c.pop("dropout", 0.0)
    kw = dict(compressor=c["compressor"], server=c["server"], local_steps=tau,
              local_budget=10.0 if tau > 1 else None)
    jcomp = JConfig(budget=JBudget(value=c["budget"]), **kw)
    tcomp = CompressionConfig(budget=BudgetConfig(value=c["budget"]), **kw)
    jpart = tpart = None
    if weights is not None:
        jpart = jcoll.ParticipationSpec(weights=weights, dropout=dropout)
        tpart = ParticipationSpec(weights=weights, dropout=dropout)
    return jcomp, tcomp, jpart, tpart


@pytest.mark.parametrize("case", list(CASES))
def test_m4_injected_gradients_match_the_jax_oracle(case):
    """Two rounds at M = 4 on the packed wire; the rounds' seeds, masks and
    (for the elastic case) dropped reports differ, and each equals the
    oracle bit for bit."""
    jcomp, tcomp, jpart, tpart = _configs(case)
    step = build_train_step(InjectedModel(), TrainStepConfig(
        compression=tcomp, lr=LrSchedule(base=0.05), vote_impl="allgather_packed",
        participation=tpart), make_mesh((M,), ("data",)))
    params, _, _ = _injected(0)
    state = init_state(params_from_numpy({"blocks": ({"a": params[0], "b": params[1]},),
                                          "embed": params[2], "final_norm": params[3]}),
                       server=tcomp.server, seed=11)
    dropped = 0
    for r in range(2):
        _, per, batch = _injected(r + 1)
        want = jax_oracle(params, per, jcomp, seed=11, step=r, lr=np.float32(0.05), part=jpart)
        state, metrics = step(state, batch)
        got = [t.numpy().copy() for t in tree_leaves(state.params)]   # the next step donates
        for a, b in zip(got, want):
            np.testing.assert_array_equal(f32bits(a), f32bits(b))
        assert any((a != p).any() for a, p in zip(got, params)), "the round must move"
        params = got
        dropped += M - int(float(metrics["participated"]))
    if jpart is not None:
        assert dropped > 0, "the elastic case must drop a report in two rounds"


def test_tau2_local_steps_match_the_jax_oracle():
    jcomp, tcomp, _, _ = _configs("sparsign", tau=2)
    step = build_train_step(InjectedModel(), TrainStepConfig(
        compression=tcomp, lr=LrSchedule(base=0.05), local_lr=0.01,
        vote_impl="allgather_packed"), make_mesh((M,), ("data",)))
    params, per, batch = _injected(3, tau=2)
    state = init_state(params_from_numpy({"blocks": ({"a": params[0], "b": params[1]},),
                                          "embed": params[2], "final_norm": params[3]}),
                       server=tcomp.server, seed=4)
    state, _ = step(state, batch)
    want = jax_oracle(params, per, jcomp, seed=4, step=0, lr=np.float32(0.05), local_lr=0.01)
    for a, b in zip(tree_leaves(state.params), want):
        np.testing.assert_array_equal(f32bits(a.numpy()), f32bits(b))


# ------------------------------------------------ (c) the three wires agree

@pytest.mark.parametrize("elastic", [False, True])
def test_psum_hier_and_packed_wires_give_equal_parameters(elastic):
    """The smoke model at M = 4 for two rounds: psum on ('data',), hier on
    ('pod', 'data') = 2 x 2 and allgather_packed, bit for bit. Elastic
    weights are dyadic, so every float order gives the same sums."""
    tm = Model(get_config("qwen1.5-4b", smoke=True))
    part = (ParticipationSpec(weights=(1.5, 0.5, 2.0, 1.0), dropout=0.25) if elastic else None)
    comp = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                             server="majority_vote")
    results = {}
    for impl, group in (("psum", make_mesh((4,), ("data",))),
                        ("hier", make_mesh((2, 2), ("pod", "data"))),
                        ("allgather_packed", make_mesh((4,), ("data",)))):
        step = build_train_step(tm, TrainStepConfig(
            compression=comp, lr=LrSchedule(base=0.05), vote_impl=impl,
            participation=part), group)
        state = init_state(tm.init(0, device="cpu"), server=comp.server, seed=3)
        for r in range(2):
            state, metrics = step(state, _smoke_batch(r, b=4))
        results[impl] = ([t.numpy() for t in tree_leaves(state.params)], metrics)
    ref, ref_m = results["psum"]
    for impl, (leaves, m) in results.items():
        for a, b in zip(leaves, ref):
            np.testing.assert_array_equal(f32bits(a), f32bits(b), err_msg=impl)
        assert float(m["nnz_frac"]) == float(ref_m["nnz_frac"])
        assert float(m["participated"]) == float(ref_m["participated"])


def test_trainer_refuses_what_is_not_ported():
    tm = Model(get_config("qwen1.5-4b", smoke=True))
    comp = CompressionConfig()
    group = make_host_mesh(2)
    # the bucketed uplink and the ring gather are ported: the steps build
    step = build_train_step(tm, TrainStepConfig(compression=comp, lr=LrSchedule(),
                                                bucketed=True), group)
    assert step.plan is not None and step.plan.fmt == "int8"
    step = build_train_step(tm, TrainStepConfig(compression=comp, lr=LrSchedule(),
                                                vote_impl="allgather_packed",
                                                ring_chunk_rows=64), group)
    assert step.plan is None and step.wire.ring_chunk_rows == 64
    with pytest.raises(ValueError, match="two worker axes"):
        build_train_step(tm, TrainStepConfig(compression=comp, lr=LrSchedule(),
                                             vote_impl="hier"), group)
    with pytest.raises(ValueError, match="scaled_sign_ef"):
        build_train_step(tm, TrainStepConfig(
            compression=dataclasses.replace(comp, server="scaled_sign_ef"), lr=LrSchedule(),
            participation=ParticipationSpec(dropout=0.1)), group)
