"""The port's MoE layer against the reference's ``moe_block`` at smoke
width, with the reference's weights and numpy inputs: the routing
(``gate_idx``, each assignment's slot and the ``keep`` mask) exactly, the
output at rtol 1e-5 and the Switch aux loss, with and without forced drops
(capacity factor 0.5), in one and two groups, and with pad experts; and
with the ``moe`` family's shared expert (a gated MLP of its own width
added to the routed output).  The reference is evaluated op by op, and
its top-k and slot positions are read off the calls it makes."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch.models import moe as TM

torch.set_num_threads(1)

D, E, K, FF = 64, 4, 2, 64            # jamba's smoke widths


def _pair(pad=0, seed=0, shared_ff=0):
    n_shared = int(shared_ff > 0)
    jp = JM.init_moe(jax.random.key(seed), D, FF, E, n_shared, shared_ff,
                     dtype=jnp.float32, expert_pad=pad)
    p = TM.MoE(D, FF, E, n_shared=n_shared, shared_ff=shared_ff,
               expert_pad=pad, device="cpu")
    p.load_state_dict({k: torch.tensor(np.asarray(v))
                       for k, v in _flat(jp).items()}, strict=True)
    return jp, p


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _reference(jp, x, monkeypatch, **kw):
    """The reference's (out, aux), with the gate_idx and slot positions
    its top_k and take_along_axis calls returned."""
    seen = {}
    top_k, take = jax.lax.top_k, jnp.take_along_axis

    def rec_top_k(*a, **k):
        seen["gate_idx"] = np.asarray(top_k(*a, **k)[1])
        return top_k(*a, **k)

    def rec_take(*a, **k):
        seen["pos"] = np.asarray(take(*a, **k))[..., 0]
        return take(*a, **k)

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jnp, "take_along_axis", rec_take)
    with jax.disable_jit():
        out, aux = JM.moe_block(jp, jnp.asarray(x), n_experts=E, top_k=K,
                                **kw)
    monkeypatch.undo()
    return np.asarray(out), float(aux), seen


@pytest.mark.parametrize("capacity_factor,n_groups,pad", [
    (1.25, 1, 0), (0.5, 1, 0), (0.5, 2, 0), (0.5, 2, 2)])
def test_moe_block_matches_reference(capacity_factor, n_groups, pad,
                                     monkeypatch):
    jp, p = _pair(pad, seed=n_groups + pad)
    x = np.random.default_rng(1).standard_normal((2, 16, D)) \
        .astype(np.float32)
    kw = dict(capacity_factor=capacity_factor, n_groups=n_groups)
    want, want_aux, seen = _reference(jp, x, monkeypatch, **kw)

    r = TM.route(p, torch.tensor(x), n_experts=E, top_k=K, **kw)
    tg = 32 // n_groups
    assert r["cap"] == max(math.ceil(tg * K / E * capacity_factor), 1)
    np.testing.assert_array_equal(r["gate_idx"].numpy(), seen["gate_idx"])
    np.testing.assert_array_equal(r["pos"].numpy(), seen["pos"])
    np.testing.assert_array_equal(r["keep"].numpy(), seen["pos"] < r["cap"])
    if capacity_factor < 1:
        assert (~r["keep"]).any()               # drops forced

    out, aux = TM.moe_block(p, torch.tensor(x), n_experts=E, top_k=K, **kw)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-6)


@pytest.mark.parametrize("capacity_factor,n_groups,pad", [
    (1.25, 1, 0), (0.5, 2, 4)])
def test_moe_block_with_shared_expert_matches_reference(
        capacity_factor, n_groups, pad, monkeypatch):
    """qwen2-moe's layout at smoke width: a shared expert of width 128
    (the config's d_ff) beside the routed experts, with and without drops
    and pad experts; its output is the routed output plus the shared
    MLP's."""
    jp, p = _pair(pad, seed=7 + pad, shared_ff=128)
    assert p.shared is not None and p.shared.gated
    assert tuple(p.shared.w_up.shape) == (D, 128)
    x = np.random.default_rng(5).standard_normal((2, 16, D)) \
        .astype(np.float32)
    kw = dict(capacity_factor=capacity_factor, n_groups=n_groups)
    want, want_aux, seen = _reference(jp, x, monkeypatch, **kw)
    out, aux = TM.moe_block(p, torch.tensor(x), n_experts=E, top_k=K, **kw)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-6)
    shared = p.shared
    p.shared = None
    routed, _ = TM.moe_block(p, torch.tensor(x), n_experts=E, top_k=K, **kw)
    p.shared = shared
    np.testing.assert_allclose(
        (out - routed).numpy(),
        np.asarray(JL.mlp(jp["shared"], jnp.asarray(x), gated=True)),
        rtol=1e-4, atol=1e-5)


def test_dropped_assignments_leave_the_kept_occupant_of_slot_zero():
    """Dropped assignments are sent to (group, expert 0, slot 0) with a
    zero source; expert 0's real slot-0 token must come through intact."""
    _, p = _pair(seed=4)
    x = torch.tensor(np.random.default_rng(2).standard_normal((1, 32, D)),
                     dtype=torch.float32)
    kw = dict(n_experts=E, top_k=K, capacity_factor=0.25)
    r = TM.route(p, x, **kw)
    fe, keep = r["flat_expert"][0], r["keep"][0]
    assert (~keep).any()
    first = int(torch.nonzero(fe == 0)[0])         # expert 0's slot-0 owner
    assert keep[first]
    out, _ = TM.moe_block(p, x, **kw)
    tok = first // K
    gate = r["gate_vals"][0].reshape(-1)
    # that token's expert-0 contribution, computed by hand
    xe = x[0, tok]
    h = torch.nn.functional.silu(xe @ p.w_gate[0]) * (xe @ p.w_up[0])
    mine = gate[first] * (h @ p.w_down[0])
    other = first + 1 if first % K == 0 else first - 1
    if keep[other]:
        e2 = int(fe[other])
        h2 = torch.nn.functional.silu(xe @ p.w_gate[e2]) * (xe @ p.w_up[e2])
        mine = mine + gate[other] * (h2 @ p.w_down[e2])
    np.testing.assert_allclose(out[0, tok].numpy(), mine.numpy(), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------ the block's spans
class _CountOps:
    """The aten ops a block dispatches, by name."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counts = self.counts = {}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = str(func.overloadpacket)
                counts[name] = counts.get(name, 0) + 1
                return func(*args, **(kwargs or {}))

        self.mode = Mode()


def _small_block(pad, shared_ff):
    p = TM.MoE(D, FF, E, n_shared=int(shared_ff > 0), shared_ff=shared_ff,
               expert_pad=pad, device="cpu")
    gen = torch.Generator().manual_seed(0)
    p.init_weights(gen)
    return p, torch.randn(2, 16, D, generator=gen)


# what the block dispatched before it was instrumented (same torch build)
_PARENT_OPS = {(0, 0): 104, (2, 32): 116}


@pytest.mark.parametrize("pad,shared_ff", sorted(_PARENT_OPS))
def test_untraced_block_dispatches_the_ops_it_did(pad, shared_ff):
    from repro_torch.obs import PROCESS_TRACER
    p, x = _small_block(pad, shared_ff)
    assert not PROCESS_TRACER.enabled
    c = _CountOps()
    with c.mode:
        TM.moe_block(p, x, n_experts=E, top_k=K, capacity_factor=1.0,
                     n_groups=2)
    assert sum(c.counts.values()) == _PARENT_OPS[(pad, shared_ff)]
    assert "aten.sum" in c.counts and c.counts["aten.sum"] == 3


@pytest.mark.parametrize("capacity_factor,n_groups", [(1.25, 1), (0.5, 2)])
def test_traced_block_counts_its_dispatch(capacity_factor, n_groups):
    """Under torch.profiler: the same output, moe.dispatch inside
    moe.block, and its counts route's keep and cap."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import PROCESS_TRACER
    p, x = _small_block(2, 32)
    kw = dict(n_experts=E, top_k=K, capacity_factor=capacity_factor,
              n_groups=n_groups)
    plain = TM.moe_block(p, x, **kw)
    PROCESS_TRACER.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = TM.moe_block(p, x, **kw)
    spans = {s.name: s for s in PROCESS_TRACER.drain()}
    assert torch.equal(traced[0], plain[0]) and torch.equal(traced[1],
                                                            plain[1])
    assert set(spans) == {"moe.block", "moe.dispatch"}
    assert spans["moe.dispatch"].parent_id == spans["moe.block"].span_id
    r = TM.route(p, x, **kw)
    g_n = r["keep"].shape[0]
    assert spans["moe.dispatch"].attrs == {
        "kept": int(r["keep"].sum()), "assigned": r["keep"].numel(),
        "slots": g_n * (E + 2) * r["cap"]}
    if capacity_factor < 1:
        assert spans["moe.dispatch"].attrs["kept"] < r["keep"].numel()
