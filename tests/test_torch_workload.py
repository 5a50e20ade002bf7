"""Workloads from the architecture configs: the port's ``from_arch`` and
``zoo_suite`` against the reference's, op for op and field for field (both
sides are numpy, so everything is exact: names, kinds, FLOPs, bytes, dims,
collective bytes, counts, and the stacked union's bookkeeping)."""
import dataclasses

import numpy as np
import pytest

from repro.configs import ARCHS as J_ARCHS
from repro.perfmodel import workload as J_W
from repro_torch.configs import ARCHS
from repro_torch.perfmodel import workload as T_W

ARCH_NAMES = sorted(J_ARCHS)
OP_FIELDS = tuple(f.name for f in dataclasses.fields(J_W.Op))
# (batch, seq, tp, kv_len): the zoo's operating point, a small grid around
# it, odd sizes (the integer divisions and max(1, .) guards), and tp 1
GRID = [(8, 2048, 8, None), (8, 2048, 8, 3072), (1, 1, 1, None),
        (3, 17, 4, 100), (2, 512, 16, 4096), (5, 333, 2, 7)]
TEST_ARCHS = ("qwen2-moe-a2.7b", "rwkv6-7b", "llama3.2-1b")


def assert_same_workload(got, want):
    assert got.name == want.name
    assert got.tp == want.tp
    assert [o.name for o in got.ops] == [o.name for o in want.ops]
    for a, b in zip(got.ops, want.ops):
        for f in OP_FIELDS:
            va, vb = getattr(a, f), getattr(b, f)
            assert va == vb and type(va) is type(vb), (want.name, a.name, f,
                                                       va, vb)
    ga, gb = got.arrays(), want.arrays()
    assert list(ga) == list(gb)
    for k in gb:
        assert ga[k].dtype == gb[k].dtype and np.array_equal(ga[k], gb[k]), k


def test_configs_match_the_reference():
    """Every field of the reference's ArchConfig equal, for every arch and
    its smoke(); the port's own fields (Finch's layer) at their defaults."""
    assert sorted(ARCHS) == ARCH_NAMES and len(ARCH_NAMES) == 10
    for name in ARCH_NAMES:
        for got, want in ((ARCHS[name], J_ARCHS[name]),
                          (ARCHS[name].smoke(), J_ARCHS[name].smoke())):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert {k: got[k] for k in want} == want
            assert {k: v for k, v in got.items() if k not in want} == \
                {"rwkv_mix_lora": 0, "rwkv_decay_lora": 0}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_from_arch_matches_reference(arch, smoke):
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    if smoke:
        cfg, jcfg = cfg.smoke(), jcfg.smoke()
    for batch, seq, tp, kv_len in GRID:
        for decode in (False, True):
            got = T_W.from_arch(cfg, batch, seq, tp=tp, decode=decode,
                                kv_len=kv_len)
            want = J_W.from_arch(jcfg, batch, seq, tp=tp, decode=decode,
                                 kv_len=kv_len)
            assert_same_workload(got, want)
    # default arguments (tp 8, prefill, kv_len = seq)
    assert_same_workload(T_W.from_arch(cfg, 8, 2048),
                         J_W.from_arch(jcfg, 8, 2048))


def test_block_builders_match_reference():
    """The per-block builders one by one, at off-grid sizes (fractional
    token counts reach the MoE's m_eff = M * top_k / tp)."""
    cases = [
        ("_attn_block", dict(pfx="a", batch=3, q_len=5, kv_len=77, d=96.0,
                             n_heads=6, n_kv=2, head_dim=16, tp=4,
                             qkv_bias=True, count=3, decode=False)),
        ("_attn_block", dict(pfx="a", batch=3, q_len=1, kv_len=77, d=96.0,
                             n_heads=6, n_kv=2, head_dim=16, tp=8,
                             qkv_bias=False, count=3, decode=True)),
        ("_ffn_block", dict(pfx="f", M=15.0, d=96.0, d_ff=250.0, tp=3,
                            gated=True, count=2)),
        ("_ffn_block", dict(pfx="f", M=15.0, d=96.0, d_ff=250.0, tp=3,
                            gated=False, count=2)),
        ("_moe_block", dict(pfx="m", M=15.0, d=96.0, expert_ff=40.0,
                            n_experts=7, top_k=3, n_shared=2, tp=4,
                            count=5)),
        ("_moe_block", dict(pfx="m", M=7.0, d=96.0, expert_ff=40.0,
                            n_experts=7, top_k=2, n_shared=0, tp=8,
                            count=5)),
        ("_ssm_block", dict(pfx="s", batch=3, q_len=5, d=96.0, d_state=16,
                            tp=4, count=2, decode=False)),
        ("_ssm_block", dict(pfx="s", batch=3, q_len=1, d=96.0, d_state=16,
                            tp=4, count=2, decode=True)),
        ("_rwkv_block", dict(pfx="r", batch=3, q_len=5, d=192.0,
                             d_ff=500.0, tp=4, count=2, decode=False)),
        ("_rwkv_block", dict(pfx="r", batch=3, q_len=1, d=192.0,
                             d_ff=500.0, tp=16, count=2, decode=True)),
    ]
    for fn, kw in cases:
        got, want = [], []
        getattr(T_W, fn)(got, **kw)
        getattr(J_W, fn)(want, **kw)
        assert_same_workload(T_W.Workload("w", got), J_W.Workload("w", want))
    moe = []
    T_W._moe_block(moe, "m", M=7.0, d=96.0, expert_ff=40.0, n_experts=7,
                   top_k=2, n_shared=0, tp=8, count=1)
    assert moe[3].name == "m.exp_up" and moe[3].m == 1.75   # off-grid m


@pytest.mark.parametrize("kw", [
    {}, {"smoke": True}, {"archs": TEST_ARCHS, "smoke": True},
    {"archs": ("whisper-medium", "jamba-1.5-large-398b"), "batch": 4,
     "seq": 512, "tp": 4, "out_pos": 100},
], ids=["full", "smoke", "test-archs", "kwargs"])
def test_zoo_suite_matches_reference(kw):
    wls, scen = T_W.zoo_suite(**kw)
    jwls, jscen = J_W.zoo_suite(**kw)
    assert list(wls) == list(jwls)
    assert [dataclasses.astuple(s) for s in scen] == \
        [dataclasses.astuple(s) for s in jscen]
    for nm in jwls:
        assert_same_workload(wls[nm], jwls[nm])
    stack, jstack = T_W.WorkloadStack.build(wls), J_W.WorkloadStack.build(jwls)
    assert stack.names == jstack.names
    assert stack.n_unique == jstack.n_unique
    assert stack.total_ops == jstack.total_ops
    for f in T_W.STACK_KEY_FIELDS:
        assert stack.unique[f].dtype == jstack.unique[f].dtype
        assert np.array_equal(stack.unique[f], jstack.unique[f]), f
    for nm in jstack.names:
        assert np.array_equal(stack.op_map[nm], jstack.op_map[nm])
        assert np.array_equal(stack.counts[nm], jstack.counts[nm])
    assert np.array_equal(stack.count_matrix, jstack.count_matrix)


def test_zoo_suite_at_full_width():
    """The zoo's default operating point: 10 scenarios, 20 workloads, 351
    op rows, 230 distinct rows in the stacked union."""
    wls, scen = T_W.zoo_suite()
    assert len(scen) == 10 and len(wls) == 20
    assert sum(len(w.ops) for w in wls.values()) == 351
    assert T_W.WorkloadStack.build(wls).n_unique == 230
    rows = {nm: len(w.ops) for nm, w in wls.items()}
    assert rows["whisper-medium:prefill"] == 32
    assert rows["whisper-medium:decode"] == 21
    assert rows["rwkv6-7b:prefill"] == rows["rwkv6-7b:decode"] == 11
    assert rows["jamba-1.5-large-398b:decode"] == 26
    for s in scen:
        assert wls[s.decode].name.endswith("-kv3072-tp8")
