"""ppa_eval's plain PyTorch version against the reference kernel (interpret
mode) and its oracle, at the reference's own kernel tolerances."""
import os
import re

import numpy as np
import pytest
import torch

from repro.kernels.ppa_eval.ops import ppa_eval as j_ppa_eval
from repro.kernels.ppa_eval.ref import op_table as j_op_table
from repro.kernels.ppa_eval.ref import ppa_eval_ref
from repro.perfmodel import workload as J_W
from repro_torch.kernels.ppa_eval import (KernelTables, kernel_tables,
                                          op_table, op_table_tensor, ppa_eval,
                                          ppa_eval_op_count, ppa_eval_plain,
                                          ppa_eval_workloads, workload_tp)
from repro_torch.kernels.ppa_eval import ops
from repro_torch.kernels.ppa_eval.bench import design_batches
from repro_torch.kernels.ppa_eval.ops import SOURCE
from repro_torch.perfmodel import workload as T_W
from repro_torch.perfmodel.designspace import SPACE
from repro_torch.perfmodel.evaluator import evaluator_for_model
from repro_torch.perfmodel.roofline import RooflineModel

torch.set_num_threads(1)

WHICH = ["prefill", "decode"]


def _plain(idx, wl):
    dv = SPACE.decode_values(torch.as_tensor(idx))
    return ppa_eval_plain(dv, op_table_tensor(wl, "cpu"),
                          workload_tp(wl)).numpy()


@pytest.mark.parametrize("which", WHICH)
@pytest.mark.parametrize("n", [64, 300])
def test_plain_matches_reference_kernel_and_oracle(which, n):
    wl = getattr(T_W, f"gpt3_layer_{which}")()
    jwl = getattr(J_W, f"gpt3_layer_{which}")()
    idx = SPACE.sample(np.random.default_rng(7), n)
    out = _plain(idx, wl)
    assert out.shape == (n, 8) and out.dtype == np.float32
    assert np.array_equal(out[:, 6:], np.zeros((n, 2), np.float32))
    kern = j_ppa_eval(idx, jwl, interpret=True)
    ref = ppa_eval_ref(idx, jwl)
    for lat, stall, area in ((kern["latency"], kern["stall"], kern["area"]),
                             (ref[:, 0], ref[:, 1:5], ref[:, 5])):
        np.testing.assert_allclose(out[:, 0], lat, rtol=1e-4)
        np.testing.assert_allclose(out[:, 5], area, rtol=1e-5)
        np.testing.assert_allclose(out[:, 1:5], stall, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("which", WHICH)
def test_op_table_matches_reference(which):
    wl = getattr(T_W, f"gpt3_layer_{which}")()
    jwl = getattr(J_W, f"gpt3_layer_{which}")()
    assert np.array_equal(op_table(wl), j_op_table(jwl))
    assert workload_tp(wl) == float(jwl.tp)
    tab = op_table_tensor(wl, "cpu")
    assert tab.dtype == torch.float32 and tab.is_contiguous()


@pytest.mark.parametrize("which", WHICH)
def test_plain_equals_the_torch_roofline_path_bitwise(which):
    """The kernel's arithmetic contract, checked on its plain twin: the same
    expressions in the same order as the roofline stalls path."""
    wl = getattr(T_W, f"gpt3_layer_{which}")()
    idx = SPACE.sample(np.random.default_rng(8), 700)
    out = _plain(idx, wl)
    rep = evaluator_for_model(RooflineModel(wl), device="cpu").stalls(idx)
    w = rep.workloads[0]
    assert np.array_equal(out[:, 0], rep.latency[w])
    assert np.array_equal(out[:, 1:5], rep.stall[w])
    assert np.array_equal(out[:, 5], rep.area)


def test_cpu_tensor_runs_the_plain_version_uncounted():
    wl = T_W.gpt3_layer_prefill()
    idx = SPACE.sample(np.random.default_rng(9), 33)
    dv = SPACE.decode_values(torch.as_tensor(idx))
    tab = op_table_tensor(wl, "cpu")
    before = ppa_eval.launches
    assert torch.equal(ppa_eval(dv, tab, 8.0), ppa_eval_plain(dv, tab, 8.0))
    assert ppa_eval.launches == before


def _fp32_ops(code: str) -> int:
    """fp32 operations written in a piece of CUDA source: each arithmetic
    operator, comparison, fminf/fmaxf/sqrtf and `+=` is one; ceil_div is a
    division and a ceil."""
    code = re.sub(r"//[^\n]*", "", code)
    toks = re.findall(r"ceil_div|fminf|fmaxf|sqrtf|\+=|>=|[-+*/>]", code)
    return sum(2 if t == "ceil_div" else 1 for t in toks)


def test_op_count_follows_the_op_kinds():
    """ppa_eval_op_count (behind chip_smoke's bound) equals the operations
    counted in ppa_eval.cu's source, for each GPT-3 table and for both in
    one launch.  A kind's operations lie in three places there: the op's
    staged terms (stage_op), the per-(op, sa_dim) terms of a matmul
    (sa_terms) and the op loop's branch."""
    src = SOURCE.read_text()

    def between(a, b):
        i = src.index(a)
        return src[i:src.index(b, i)]

    def branches(code):
        """{kind: operations} of the `if (kind == X) {...}` branches."""
        out = {}
        for a, b, body in re.findall(
                r"kind == (\w+)(?: \|\| kind == (\w+))?\) \{([^}]*)\}",
                code):
            for k in filter(None, (a, b)):
                out[getattr(T_W, k)] = out.get(getattr(T_W, k), 0) \
                    + _fp32_ops(body)
        return out

    per_design = _fp32_ops(between("// derive_hardware", "return d;"))
    # the common tail, plus the one stall sum that takes t_op
    per_op = _fp32_ops(between("// memcpy:", "if (dom_comm)")) + 1
    staged = branches(between("StagedOp stage_op(", "return s;"))
    looped = branches(between("void add_op(", "// memcpy:"))
    by_kind = {k: staged.get(k, 0) + looped.get(k, 0)
               for k in set(staged) | set(looped)}
    by_kind[T_W.MATMUL] += _fp32_ops(between("float2 sa_terms(", "\n}\n"))
    assert set(by_kind) == {T_W.MATMUL, T_W.VECTOR, T_W.ALLREDUCE, T_W.P2P}
    counts = {}
    tabs = {which: op_table(getattr(T_W, f"gpt3_layer_{which}")())
            for which in WHICH}
    for which, tab in tabs.items():
        want = per_design + sum(per_op + by_kind.get(int(k), 0)
                                for k in tab[:, 0])
        counts[which] = ppa_eval_op_count(tab)
        assert counts[which] == want, which
    assert counts["decode"] < counts["prefill"]
    assert (ppa_eval_op_count(*tabs.values())
            == sum(counts.values()) - per_design)


def test_ppa_eval_workloads_slices_each_workloads_row():
    wls = [T_W.gpt3_layer_prefill(), T_W.gpt3_layer_decode()]
    idx = SPACE.sample(np.random.default_rng(10), 97)
    dv = SPACE.decode_values(torch.as_tensor(idx))
    tables = kernel_tables(wls, "cpu")
    lat, area, stall = ppa_eval_workloads(dv, tables)
    for j, wl in enumerate(wls):
        out = ppa_eval_plain(dv, op_table_tensor(wl, "cpu"), workload_tp(wl))
        assert torch.equal(lat[j], out[:, 0])
        assert torch.equal(stall[j], out[:, 1:5])
        assert torch.equal(area, out[:, 5])


# ---------------------------------------------------------------------------
# one launch for several workloads; the block's per-(op, sa_dim) table
# ---------------------------------------------------------------------------

def _source_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SOURCE.read_text()).group(1))


def test_wrapper_constants_are_the_kernels():
    """ops.py's block geometry and limits are ppa_eval.cu's constants, and
    the largest launch ops.MAX_OPS allows fits a block's shared memory."""
    assert ops.BLOCK == _source_const("kThreads")
    assert ops.MAX_SA == _source_const("kMaxSa")
    assert ops.MAX_WORKLOADS == _source_const("kMaxWorkloads")
    assert ops.SMEM_PER_OP == 32 + 8 * ops.MAX_SA   # StagedOp + float2s
    static = 8 * ops.MAX_SA                          # the sa keys
    assert ops.MAX_OPS * ops.SMEM_PER_OP + static <= 232_448
    assert len(SPACE.choices[SPACE.names.index("sa_dim")]) <= ops.MAX_SA


def _tables(tps=(8.0, 8.0, 4.0)):
    """The GPT-3 prefill and decode tables and the prefill table again at
    another tp, as (fp32 table, tp) pairs."""
    tabs = [op_table_tensor(T_W.gpt3_layer_prefill(), "cpu"),
            op_table_tensor(T_W.gpt3_layer_decode(), "cpu"),
            op_table_tensor(T_W.gpt3_layer_prefill(), "cpu")]
    return list(zip(tabs, tps))


def test_packed_tables_round_trip():
    pairs = _tables()
    packed = KernelTables.pack(pairs)
    sizes = [t.shape[0] for t, _ in pairs]
    assert packed.ends == tuple(np.cumsum(sizes).tolist())
    assert packed.tps == (8.0, 8.0, 4.0) and len(packed) == 3
    assert packed.ops.is_contiguous() and packed.ops.dtype == torch.float32
    assert torch.equal(packed.ops, torch.cat([t for t, _ in pairs]))
    for (t, tp), (u, up) in zip(pairs, packed.unpack()):
        assert torch.equal(t, u) and tp == up
    wls = [T_W.gpt3_layer_prefill(), T_W.gpt3_layer_decode()]
    kt = kernel_tables(wls, "cpu")
    assert kt.ends == (13, 26) and kt.tps == (8.0, 8.0)
    assert np.array_equal(kt.table(1).numpy(),
                          op_table(wls[1]).astype(np.float32))
    one = KernelTables.pack(pairs[:1])           # one table: no copy
    assert one.ops.data_ptr() == pairs[0][0].data_ptr()


def test_packed_tables_are_checked():
    dv = SPACE.decode_values(torch.as_tensor(
        SPACE.sample(np.random.default_rng(2), 5)))
    tab = op_table_tensor(T_W.gpt3_layer_decode(), "cpu")
    too_many = KernelTables.pack([(tab, 8.0)] * (ops.MAX_WORKLOADS + 1))
    with pytest.raises(ValueError, match="workloads"):
        ppa_eval_workloads(dv, too_many)
    long = tab.repeat(-(-ops.MAX_OPS // tab.shape[0]), 1)[:ops.MAX_OPS]
    too_long = KernelTables.pack([(long.contiguous(), 8.0), (tab[:1], 8.0)])
    with pytest.raises(ValueError, match="shared memory"):
        ppa_eval_workloads(dv, too_long)
    with pytest.raises(ValueError, match="rows"):
        ppa_eval_workloads(dv, KernelTables.pack([(tab, 8.0),
                                                  (tab[:0], 8.0)]))
    with pytest.raises(ValueError, match="cover"):
        ppa_eval_workloads(dv, KernelTables(tab, (5,), (8.0,)))
    lat, _, _ = ppa_eval_workloads(
        dv, KernelTables.pack([(tab, 8.0)] * ops.MAX_WORKLOADS))
    assert len(lat) == ops.MAX_WORKLOADS


def test_ppa_eval_workloads_on_cpu_returns_each_plain_row():
    """The CPU path: each workload's ppa_eval_plain rows, whatever its tp,
    on sampled and off-grid designs; nothing counted as a launch."""
    pairs = _tables()
    packed = KernelTables.pack(pairs)
    for name, dv in design_batches(77, "cpu", seed=3).items():
        before = ppa_eval.launches
        lat, area, stall = ppa_eval_workloads(dv, packed)
        assert ppa_eval.launches == before
        for j, (tab, tp) in enumerate(pairs):
            out = ppa_eval_plain(dv, tab, tp)
            assert torch.equal(lat[j], out[:, 0]), name
            assert torch.equal(stall[j], out[:, 1:5]), name
            assert torch.equal(area, out[:, 5]), name
    assert not torch.equal(lat[0], lat[2])        # tp 4 is another result


def _sa_terms(m, n, k, sa):
    """sa_terms in ppa_eval.cu: (u_k * u_n * u_pipe, tile count)."""
    u_k = k / (torch.ceil(k / sa) * sa)
    u_n = n / (torch.ceil(n / sa) * sa)
    u_pipe = m / (m + sa)
    return u_k * u_n * u_pipe, torch.ceil(m / sa) * torch.ceil(n / sa)


def _kernel_order(dv: torch.Tensor, packed: KernelTables,
                  max_sa: int) -> torch.Tensor:
    """ppa_eval.cu's division of the work, in torch ops -> (n_workloads,
    B, 8).  Terms of an op and its workload's tp are formed once per op
    (stage_op); per block of ops.BLOCK designs, the first `max_sa` distinct
    sa values (by bits) get a slot, sa_terms is evaluated once per (slot,
    matmul op) and looked up by each design, and a design without a slot
    evaluates it itself; the rest is the op loop."""
    from repro_torch.perfmodel.hardware import (BW_PER_CHANNEL, BW_PER_LINK,
                                                CLOCK_HZ, LINK_LATENCY_S)
    from repro_torch.perfmodel.roofline import SRAM_FEED_WORDS_PER_KB
    links, cores, sub, sa, vw, sram, gbuf_mb, chan = dv.unbind(1)
    tensor = cores * sub * sa * sa * 2.0 * CLOCK_HZ
    vector = cores * sub * vw * 2.0 * CLOCK_HZ
    mem_bw = chan * BW_PER_CHANNEL
    ici_bw = links * BW_PER_LINK
    sqrt_f = torch.sqrt(torch.clamp(gbuf_mb * 2.0**20 / 2.0, min=1.0))
    u_sram = torch.clamp(sram / (6.0 * sa * sa * 2.0 / 1024.0), max=1.0)
    u_feed = torch.clamp(SRAM_FEED_WORDS_PER_KB * sram / (sa * sub), max=1.0)
    par = cores * sub
    area = ppa_eval_plain(dv, packed.table(0), packed.tps[0])[:, 5]

    # the block's slots: (slot value per design, whether it has one)
    bits = sa.view(torch.int32)
    slotted = torch.zeros_like(bits, dtype=torch.bool)
    uniq_of = torch.zeros_like(bits, dtype=torch.long)
    uniq_sa = []
    for s in range(0, sa.shape[0], ops.BLOCK):
        blk = bits[s:s + ops.BLOCK].tolist()
        keys = list(dict.fromkeys(blk))[:max_sa]      # first come, first slot
        for i, key in enumerate(blk):
            if key in keys:
                slotted[s + i] = True
                uniq_of[s + i] = len(uniq_sa) + keys.index(key)
        uniq_sa += [sa[s + blk.index(key)] for key in keys]
    uniq_sa = torch.stack(uniq_sa) if uniq_sa else sa[:0]

    outs = []
    for tab, tp in packed.unpack():
        tp_t = torch.tensor(tp, dtype=torch.float32)
        zero = torch.zeros_like(cores)
        lat, stalls = zero, [zero] * 4
        for op in tab:
            kind = int(op[ops.OP_KIND])
            flops, nbytes, count = op[ops.OP_FLOPS], op[ops.OP_BYTES], \
                op[ops.OP_COUNT]
            m, n, k, comm = op[ops.OP_M], op[ops.OP_N], op[ops.OP_K], \
                op[ops.OP_COMM]
            t_c, t_x, bytes_eff = zero, zero, nbytes.expand_as(cores)
            if kind == T_W.MATMUL:
                mnk2 = 2.0 * m * n * k                      # staged
                pre_tab, til_tab = _sa_terms(m, n, k, uniq_sa)  # per slot
                pre_in, til_in = _sa_terms(m, n, k, sa)       # no slot
                pre, til = pre_in, til_in
                if uniq_sa.numel():
                    pre = torch.where(slotted, pre_tab[uniq_of], pre_in)
                    til = torch.where(slotted, til_tab[uniq_of], til_in)
                u_par = torch.clamp(til / par, max=1.0)
                util = pre * u_par * u_sram * u_feed
                bytes_eff = torch.maximum(bytes_eff, mnk2 / sqrt_f * 2.0)
                t_c = flops / (tensor * util)
            elif kind == T_W.VECTOR:
                t_c = flops / vector
            elif kind in (T_W.ALLREDUCE, T_W.P2P):
                if kind == T_W.ALLREDUCE:                   # staged
                    steps = 2.0 * (tp_t - 1.0)
                    a, c = steps / tp_t * comm, steps * LINK_LATENCY_S
                else:
                    a = (tp_t - 1.0) / tp_t * comm
                    c = (tp_t - 1.0) * LINK_LATENCY_S
                t_x = a / ici_bw + c
            t_m = bytes_eff / mem_bw
            t_op = torch.maximum(torch.maximum(t_c, t_m), t_x) * count
            dom_comm = (t_x >= t_c) & (t_x >= t_m)
            dom_compute = (t_c > t_m) & ~dom_comm
            cls = torch.where(dom_comm, 3, torch.where(
                dom_compute, 0 if kind == T_W.MATMUL else 1, 2))
            lat = lat + t_op
            stalls = [st + torch.where(cls == c_, t_op, 0.0)
                      for c_, st in enumerate(stalls)]
        outs.append(torch.stack([lat, *stalls, area, zero, zero], dim=1))
    return torch.stack(outs)


def _batches(n: int):
    """Sampled ids, off-grid rows (MAX_SA + 1 and n distinct sa values),
    and a run of contiguous sweep ids (sa_dim changes inside a block)."""
    from repro_torch.perfmodel.sweep import _unrank
    out = design_batches(n, "cpu", seed=n)
    ids = torch.arange(3528 - 100, 3528 - 100 + n, dtype=torch.int32)
    out["sweep ids"] = SPACE.decode_values(
        _unrank(ids, tuple(int(c) for c in SPACE.cardinalities)))
    return out


@pytest.mark.parametrize("n", [1, 300, 600])
def test_block_table_hoisting_equals_inline_expressions(n):
    """A torch-op copy of the kernel's division of the work (staged op
    terms, the per-block (sa, op) table looked up, the in-line branch for
    designs without a slot) equals ppa_eval_plain's in-line expressions
    bit for bit, on random, off-grid and contiguous rows."""
    packed = KernelTables.pack(_tables())
    max_sa = _source_const("kMaxSa")
    for name, dv in _batches(n).items():
        want = torch.stack([ppa_eval_plain(dv, t, tp)
                            for t, tp in packed.unpack()])
        got = _kernel_order(dv, packed, max_sa)
        assert torch.equal(got, want), name
        # the in-line branch alone (no slots) is the same function
        assert torch.equal(_kernel_order(dv, packed, 0), want), name


def test_block_table_hoisting_depends_on_the_product_order():
    """The check above can fail: forming u_k * (u_n * u_pipe) instead of
    (u_k * u_n) * u_pipe changes some latencies' last bits."""
    sa = _batches(600)["off-grid sa continuous"][:, 3]
    tab, _ = _tables()[0]
    kinds = tab[:, ops.OP_KIND].long()
    op = tab[int(torch.nonzero(kinds == T_W.MATMUL)[0])]
    m, n, k = op[ops.OP_M], op[ops.OP_N], op[ops.OP_K]
    u_k = k / (torch.ceil(k / sa) * sa)
    u_n = n / (torch.ceil(n / sa) * sa)
    u_pipe = m / (m + sa)
    assert torch.equal(_sa_terms(m, n, k, sa)[0], u_k * u_n * u_pipe)
    assert not torch.equal(u_k * u_n * u_pipe, u_k * (u_n * u_pipe))


def test_zoo_tables_in_kernel_order_equal_plain_and_roofline():
    """The zoo suite's 20 full-width tables packed for one launch (351 op
    rows, every family's op kinds, and the MoE's m_eff rows, whose matmul
    dims come off the designs' grid at other batch sizes): the kernel's
    division of the work equals the plain version bit for bit, and the
    plain version the zoo evaluator's stacked torch path."""
    from repro_torch.perfmodel import get_evaluator
    wls, _ = T_W.zoo_suite()
    names = list(wls)
    packed = kernel_tables(list(wls.values()), "cpu")
    assert len(packed) == 20 and packed.ends[-1] == 351
    assert 351 * ops.SMEM_PER_OP < 48 * 1024       # no opt-in needed
    max_sa = _source_const("kMaxSa")
    for name, dv in _batches(257).items():
        want = torch.stack([ppa_eval_plain(dv, t, tp)
                            for t, tp in packed.unpack()])
        assert torch.equal(_kernel_order(dv, packed, max_sa), want), name
    idx = SPACE.sample(np.random.default_rng(12), 300)
    rep = get_evaluator("proxy", suite="zoo", device="cpu").stalls(idx)
    lat, area, stall = ppa_eval_workloads(
        SPACE.decode_values(torch.as_tensor(idx)), packed)
    assert np.array_equal(area.numpy(), rep.area)
    for w, nm in enumerate(names):
        assert np.array_equal(lat[w].numpy(), rep.latency[nm]), nm
        assert np.array_equal(stall[w].numpy(), rep.stall[nm]), nm


def test_launch_count_is_exact_across_threads():
    """Worker spans launch from several threads: the counter loses no
    launch under a tiny switch interval and more threads than cores."""
    import sys
    import threading
    before = ppa_eval.launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [ops._count_launch() for _ in range(2_000)])
            for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert ppa_eval.launches == before + 2_000 * len(threads)
    finally:
        sys.setswitchinterval(old)
        ppa_eval.launches = before
