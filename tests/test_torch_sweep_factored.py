"""The factored hybrid sweep (``HybridSweepBlock`` and its layers) in the
port, against the JAX reference and against the port's unfactored scan.

  * ``simulator._sweep_block_host`` (numpy), ``_build_sweep_block`` (its
    tensors) and ``_sweep_identities`` equal the reference's leaf for leaf
    (shape, dtype, values) on the paper's 32-config grid, a band of two
    histogram groups (range 60 at 1-minute bins with range 120 at 2-minute
    bins, both 60 bins) and one config;
  * the initial carry skips only a gather its identities prove;
  * ``policy_math.hybrid_sweep_decide`` and
    ``fused_hybrid_sweep_step_math`` are bit-equal to the reference's on
    seeded float64 state, with the block's identities and without;
  * the factored plain scan equals the unfactored plain scan config by
    config in every output, the forecaster flag included, and the kernel
    layout ``factored_scan_plan`` builds (the group split above 64 configs
    included) reproduces each config;
  * ``sweep(engine="fused")`` and ``sweep(engine="kernel")`` (its plain
    version on the CPU) give rows exactly equal to the reference's
    ``sweep(engine="fused")`` on the 32-config grid, at ``app_chunk`` 7, 16
    and the automatic chunk;
  * on a CUDA card (``gpu``-marked, skipped elsewhere) the factored kernel
    equals the factored plain scan.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import experiment as E
from repro_torch.core import policy_math as pm
from repro_torch.core import simulator as sim
from repro_torch.interop import sweep_block_from_numpy, trace_from_numpy
from repro_torch.kernels import histogram as H

PCTS = ((0.0, 100.0), (5.0, 99.0), (10.0, 95.0), (15.0, 90.0))
STATE = ("prev_t", "gcum", "goob", "gcv_sum", "gcv_sum_sq", "load_c",
         "unload_c", "cold", "waste", "consulted")


def _grid32(mod):
    """The sweep benchmark's grid: 8 window variants x 4 gates, one
    histogram group of 60 bins."""
    return [mod.HybridSpec(range_minutes=60.0, head_percentile=h,
                           tail_percentile=t, cv_threshold=cv, margin=m,
                           use_arima=False)
            for m in (0.10, 0.20) for cv in (0.5, 1.0, 2.0, 4.0)
            for (h, t) in PCTS]


def _two_groups(mod):
    """Two groups of 60 bins (1- and 2-minute bins), with shared gates."""
    return [mod.HybridSpec(range_minutes=r, bin_minutes=b, cv_threshold=cv,
                           head_percentile=h, tail_percentile=t,
                           min_samples=ms, use_arima=False)
            for (r, b) in ((60.0, 1.0), (120.0, 2.0))
            for cv in (1.0, 2.0) for (h, t) in PCTS[:2] for ms in (2, 5)]


def _single(mod):
    return [mod.HybridSpec(range_minutes=60.0, use_arima=False)]


def _wide(mod):
    """One group of 70 configs: the kernel layout splits it in two."""
    return [mod.HybridSpec(range_minutes=60.0, cv_threshold=float(cv),
                           margin=m, head_percentile=h, tail_percentile=t,
                           use_arima=False)
            for cv in np.linspace(0.25, 3.0, 35) for m in (0.1, 0.2)
            for (h, t) in PCTS[1:2]]


def _columns(mod):
    """Past the register form's 256 bins: 300 bins, shared gates."""
    return [mod.HybridSpec(range_minutes=300.0, cv_threshold=cv,
                           head_percentile=h, tail_percentile=t,
                           use_arima=False)
            for cv in (1.0, 2.0) for (h, t) in PCTS[:2]]


GRIDS = {"grid32": _grid32, "two_groups": _two_groups, "single": _single}
SCAN_GRIDS = dict(GRIDS, wide=_wide, columns=_columns)


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro.core import experiment, policy_math, simulator
        from repro.core import workload_spec
        yield SimpleNamespace(E=experiment, pm=policy_math, sim=simulator,
                              ws=workload_spec, jnp=jax.numpy,
                              x64=jax.experimental.enable_x64)


def _cfgs(make):
    return [s.to_config() for s in make(E)]


def _same(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


# --------------------------------------------------------------------------
# The block and its identities, leaf for leaf
# --------------------------------------------------------------------------


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_block_and_identities_equal_the_reference(ref, grid):
    host = sim._sweep_block_host(_cfgs(GRIDS[grid]))
    blk = sim._build_sweep_block(_cfgs(GRIDS[grid]), "cpu")
    want = ref.sim._build_sweep_block(
        [s.to_config() for s in GRIDS[grid](ref.E)], np.float64)
    assert host._fields == blk._fields == want._fields
    for name, h, g, w in zip(blk._fields, host, blk, want):
        assert isinstance(h, np.ndarray), name
        _same(h, w, name)
        _same(g, w, name)
    assert tuple(sim._sweep_identities(host)) == \
        tuple(sim._sweep_identities(blk)) == \
        tuple(ref.sim._sweep_identities(want))
    G, W, T = (len(blk.g_n_bins), len(blk.w_group), len(blk.t_group))
    assert (G, W, T, len(blk.c_window)) == {
        "grid32": (1, 8, 4, 32), "two_groups": (2, 4, 8, 16),
        "single": (1, 1, 1, 1)}[grid]


@pytest.mark.parametrize("grid", sorted(SCAN_GRIDS))
def test_initial_carry_skips_only_an_identity_gather(grid):
    """The initial carry with the block's identities (the single config's
    carry gathers nothing) equals the one that gathers every selector."""
    blk = sim._build_sweep_block(_cfgs(SCAN_GRIDS[grid]), "cpu")
    n_bins = int(blk.g_n_bins.max())
    ids = sim._sweep_identities(sim._sweep_block_host(_cfgs(SCAN_GRIDS[grid])))
    assert ids.c_std == (grid == "single")
    got = sim._initial_sweep_carry(blk, 5, n_bins, torch.float64, ids)
    want = sim._initial_sweep_carry(blk, 5, n_bins, torch.float64)
    for name, g, w in zip(STATE, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    std = [c.standard_keep_alive for c in _cfgs(SCAN_GRIDS[grid])]
    assert torch.equal(got[6][:, 0], torch.tensor(std, dtype=torch.float64))


# --------------------------------------------------------------------------
# decide and the step, bit for bit against the reference
# --------------------------------------------------------------------------


def _group_state(rng, G, n, n_bins):
    """Nondecreasing cumulative rows with matching Welford sums, OOB
    counts from none to heavy, empty rows."""
    counts = rng.integers(0, 3, (G, n, n_bins))
    counts[rng.uniform(size=(G, n)) < 0.2] = 0
    counts[:, :, :n_bins // 3] *= rng.integers(0, 4, (G, n, 1))
    return dict(gcum=np.cumsum(counts, -1).astype(np.int32),
                goob=rng.integers(0, 40, (G, n)).astype(np.int32),
                gcv_sum=counts.sum(-1).astype(np.float64),
                gcv_sum_sq=(counts ** 2).sum(-1).astype(np.float64))


def _step_inputs(rng, blk, n):
    G, S = len(blk.g_n_bins), len(blk.c_window)
    n_bins = int(np.max(np.asarray(blk.g_n_bins)))
    inp = _group_state(rng, G, n, n_bins)
    prev = rng.uniform(0.0, 500.0, n)
    prev[rng.uniform(size=n) < 0.2] = -np.inf
    gap = np.where(rng.uniform(size=n) < 0.5,
                   rng.integers(0, 2 * n_bins * 64, n) / 64.0,
                   rng.uniform(0.0, 3.0 * n_bins, n))
    t_now = prev + gap
    t_now[rng.uniform(size=n) < 0.25] = np.inf
    t_now[~np.isfinite(prev)] = rng.uniform(0.0, 100.0,
                                            (~np.isfinite(prev)).sum())
    load = np.where(rng.uniform(size=(S, n)) < 0.5, 0.0,
                    rng.uniform(0.0, 30.0, (S, n)).astype(np.float32))
    inp.update(t_now=t_now, prev_t=prev,
               load_c=load.astype(np.float64),
               unload_c=(load + rng.uniform(0.0, 90.0, (S, n))
                         .astype(np.float32)).astype(np.float64),
               cold=rng.integers(0, 9, (S, n)).astype(np.int32),
               waste=rng.uniform(0.0, 1e3, (S, n)))
    return inp


@pytest.mark.parametrize("with_ids", [True, False], ids=["ids", "gathers"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_decide_and_step_bit_equal_the_reference(ref, grid, with_ids):
    rblk = ref.sim._build_sweep_block(
        [s.to_config() for s in GRIDS[grid](ref.E)], np.float64)
    ids = ref.sim._sweep_identities(rblk) if with_ids \
        else ref.pm.SweepIdentities()
    blk = sweep_block_from_numpy(rblk, device="cpu")
    pids = pm.SweepIdentities(*ids)
    inp = _step_inputs(np.random.default_rng(len(grid) + 7 * with_ids),
                       rblk, 43)
    group = ("gcum", "goob", "gcv_sum", "gcv_sum_sq")
    got = pm.hybrid_sweep_decide(*(torch.from_numpy(inp[k]) for k in group),
                                 blk, pids)
    with ref.x64():
        rb = ref.pm.HybridSweepBlock(*(ref.jnp.asarray(x) for x in rblk))
        want = ref.pm.hybrid_sweep_decide(
            *(ref.jnp.asarray(inp[k]) for k in group), rb, ids)
        want = [np.asarray(w) for w in want]
    for name, g, w in zip(("load", "unload"), got, want):
        _same(g, w, name)

    targs = {k: torch.from_numpy(v.copy()) for k, v in inp.items()}
    gcum_in = targs["gcum"]
    got = pm.fused_hybrid_sweep_step_math(**targs, blk=blk, ids=pids)
    assert got[1] is gcum_in                     # gcum updated in place
    with ref.x64():
        want = ref.pm.fused_hybrid_sweep_step_math(
            **{k: ref.jnp.asarray(v) for k, v in inp.items()}, blk=rb,
            ids=ids)
        want = [np.asarray(w) for w in want]
    for name, g, w in zip(STATE, got, want):
        _same(g, w, name)
    assert int(got[7].sum()) > int(inp["cold"].sum())


# --------------------------------------------------------------------------
# The factored plain scan against the unfactored one, config by config
# --------------------------------------------------------------------------


def _event_columns(rng, n, n_bins, width=14):
    """[width, n] float64 event columns: in-bounds, out-of-bounds and
    bin-edge gaps, late starts and early stops (+inf = no event)."""
    gaps = np.where(rng.uniform(size=(width, n)) < 0.6,
                    rng.integers(0, 2 * n_bins * 64, (width, n)) / 64.0,
                    rng.integers(0, 4 * n_bins, (width, n)).astype(float))
    t = np.cumsum(gaps, 0)
    step = np.arange(width)[:, None]
    t[(step < rng.integers(0, 4, n)) |
      (step >= rng.integers(width // 2, width + 1, n))] = np.inf
    return torch.from_numpy(t)


def _scan_case(grid, mid_trace, n=37, make=None):
    cfgs = _cfgs(make or SCAN_GRIDS[grid])
    n_bins = cfgs[0].histogram.n_bins
    blk = sim._build_sweep_block(cfgs, "cpu")
    rng = np.random.default_rng(len(grid) * 10 + mid_trace)
    cols = _event_columns(rng, n, n_bins)
    if mid_trace:
        inp = _step_inputs(rng, blk, n)
        state = [torch.from_numpy(inp[k].copy()) for k in STATE[:9]]
        state[0] = torch.where(torch.isfinite(state[0]), state[0] - 1e3,
                               state[0])
    else:
        state = list(sim._initial_sweep_carry(blk, n, n_bins,
                                              torch.float64))
    return cfgs, blk, n_bins, cols, state


def _c_group(blk):
    return blk.w_group.long()[blk.c_window.long()]


def _per_config(state, c_group):
    """The factored state as the unfactored scan's per-config state."""
    S = len(c_group)
    prev = state[0].expand(S, -1).contiguous()
    return [prev] + [x[c_group].clone() for x in state[1:5]] + \
        [x.clone() for x in state[5:9]]


def _assert_per_config(got, want, c_group, what):
    """Factored outputs ``got`` against the unfactored ``want`` of every
    config: the group state read through each config's group."""
    for k, name in enumerate(STATE):
        g = got[k]
        if name == "prev_t":
            g = g.expand_as(want[k])
        elif name in ("gcum", "goob", "gcv_sum", "gcv_sum_sq"):
            g = g[c_group]
        assert g.dtype == want[k].dtype, (what, name)
        assert torch.equal(g, want[k]), (what, name)


@pytest.mark.parametrize("mid_trace", [False, True], ids=["start", "mid"])
@pytest.mark.parametrize("grid", sorted(SCAN_GRIDS))
def test_factored_plain_scan_equals_unfactored_per_config(grid, mid_trace):
    cfgs, blk, n_bins, cols, state = _scan_case(grid, mid_trace)
    c_group = _c_group(blk)
    ci, cf = (torch.from_numpy(x) for x in sim._build_cfg_blocks(cfgs))
    bm = torch.tensor([c.histogram.bin_minutes for c in cfgs],
                      dtype=torch.float64)
    want = H.fused_hybrid_sweep_scan_plain(
        cols, *_per_config(state, c_group), ci, cf, bin_minutes=bm)
    ids = sim._sweep_identities(blk)
    gcum_in = state[1]
    before = (H.SCAN_LAUNCHES, dict(H.SCAN_LAUNCHES_BY_FORM))
    got = H.fused_hybrid_sweep_scan_factored(cols, *state, blk=blk, ids=ids)
    assert (H.SCAN_LAUNCHES, H.SCAN_LAUNCHES_BY_FORM) == before
    assert got[1] is gcum_in
    _assert_per_config(got, want, c_group, grid)
    assert int(got[7].sum()) > 0
    if mid_trace and grid != "single":           # the flag takes both values
        assert 0 < int(got[9].sum()) < got[9].numel()
    # the gathers give what the identities skip
    again = H.fused_hybrid_sweep_scan_factored_plain(
        cols, *[x.clone() for x in _scan_case(grid, mid_trace)[4]], blk=blk)
    for name, g, w in zip(STATE, again, got):
        assert torch.equal(g, w), name


def _plan_cfg_blocks(plan, blk, S):
    """Per config, what the factored kernel reads from the plan's layout:
    (the unfactored knob blocks [S, 4] / [S, 7], bin widths [S], the
    group whose state the config's kernel group carries [S])."""
    lay = plan.layout
    assert isinstance(lay, H.FactoredLayout)
    grp_i32, grp_f64, search_i32, slot_i32, slot_f32 = lay[:5]
    G = len(blk.g_n_bins)
    assert (lay.k_group is None) == (lay.first_k is None)
    k_group = lay.k_group if lay.k_group is not None else torch.arange(G)
    if lay.k_group is not None:
        assert [int(k_group[k]) for k in lay.first_k] == list(range(G))
    ci = torch.zeros((S, 4), dtype=torch.int32)
    cf = torch.zeros((S, 7), dtype=torch.float32)
    bm = torch.zeros(S, dtype=torch.float64)
    grp = torch.full((S,), -1, dtype=torch.int64)
    for k, (nb, s0, s1, q0, q1) in enumerate(grp_i32.tolist()):
        assert 0 < s1 - s0 <= 32 * plan.configs_per_lane
        assert q1 - q0 <= s1 - s0
        for slot in range(s0, s1):
            row, search, min_samples = slot_i32[slot].tolist()
            assert q0 <= search < q1 and grp[row] == -1
            ci[row] = torch.tensor([nb, *search_i32[search].tolist(),
                                    min_samples])
            cf[row] = slot_f32[slot]
            bm[row] = grp_f64[k]
            grp[row] = k_group[k]
    assert bool((grp >= 0).all())                 # every config a slot
    return ci, cf, bm, grp


@pytest.mark.parametrize("grid", sorted(SCAN_GRIDS))
def test_kernel_layout_reproduces_each_config(grid):
    """The host half of the kernel path: the form picked from the block,
    and a layout whose per-config reading (knobs, searches, the carried
    group) gives, through the unfactored plain scan, each config's row of
    the factored plain scan."""
    cfgs, blk, n_bins, cols, state = _scan_case(grid, True)
    S = len(cfgs)
    ids = sim._sweep_identities(blk)
    plan = H.factored_scan_plan(blk, ids, n_bins, "cpu")
    want_form = {"single": "registers", "columns": "columns"}.get(
        grid, "factored")
    assert plan.form == want_form
    assert plan.bins_per_lane == H.scan_form(n_bins)[1]
    got = H.fused_hybrid_sweep_scan_factored_plain(
        cols, *[x.clone() for x in state], blk=blk, ids=ids)
    c_group = _c_group(blk)
    if plan.form == "factored":
        assert plan.configs_per_lane == (2 if grid == "wide" else 1)
        assert (plan.layout.k_group is not None) == (grid == "wide")
        ci, cf, bm, grp = _plan_cfg_blocks(plan, blk, S)
        assert torch.equal(grp, c_group)
        if grid == "grid32":                     # 4 searches, not 8
            assert plan.layout.search_i32.shape == (4, 2)
    else:
        assert isinstance(plan.layout, H.ExpandedLayout)
        ci, cf, bm = plan.layout.cfg_i32, plan.layout.cfg_f32, \
            plan.layout.bin_minutes
        assert (plan.layout.c_group is None) == \
            (plan.layout.first is None) == all(ids)
        if plan.layout.c_group is not None:
            assert torch.equal(plan.layout.c_group, c_group)
    want_ci, want_cf = sim._build_cfg_blocks(cfgs)
    assert torch.equal(ci, torch.from_numpy(want_ci))
    assert torch.equal(cf, torch.from_numpy(want_cf))
    want = H.fused_hybrid_sweep_scan_plain(
        cols, *_per_config(state, c_group), ci, cf, bin_minutes=bm)
    _assert_per_config(got, want, c_group, grid)


def test_plan_refuses_a_block_it_cannot_lay_out():
    blk = sim._build_sweep_block(_cfgs(_two_groups), "cpu")
    bad = blk._replace(t_group=torch.zeros_like(blk.t_group))
    with pytest.raises(ValueError, match="group"):
        H.factored_scan_plan(bad, pm.SweepIdentities(), 60, "cpu")


# --------------------------------------------------------------------------
# sweep() rows against the reference's fused engine
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sweep32(ref):
    rtrace = ref.ws.WorkloadSpec.uniform(
        90, days=2.0, seed=5, max_events=48, min_events=1).materialize()
    want = ref.E.sweep(rtrace, _grid32(ref.E), engine="fused")
    times, counts = rtrace.to_padded()
    trace = trace_from_numpy(times, counts,
                             duration_minutes=rtrace.duration_minutes)
    return trace, want


def _assert_sweep_rows(got, want, what):
    for s in range(len(got.specs)):
        a, b = got.row(s), want.row(s)
        for f in ("cold", "invocations", "final_prewarm", "final_keep_alive",
                  "wasted_minutes"):
            np.testing.assert_array_equal(
                np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                err_msg=f"{what}: row {s} {f}")


@pytest.mark.parametrize("engine,app_chunk", [
    ("fused", None), ("kernel", None), ("fused", 7), ("kernel", 16)])
def test_sweep_rows_equal_the_reference_fused(sweep32, engine, app_chunk):
    trace, want = sweep32
    got = E.sweep(trace, _grid32(E), engine=engine,
                  options=E.EngineOptions(device="cpu", app_chunk=app_chunk))
    _assert_sweep_rows(got, want, f"{engine} app_chunk={app_chunk}")
    assert int(got.row(0).cold.sum()) > 0


def test_auto_chunk_counts_groups_not_configs():
    """The 32-config grid carries one 60-bin histogram and 32 configs'
    scalars a chunk: four single-config states and a little more, so the
    chunk is the single config's over 5 (not over 32, as unfactored)."""
    def band(make):
        cfgs = _cfgs(make)
        return sim._build_sweep_block(cfgs, "cpu"), cfgs[0].histogram.n_bins
    one = sim._state_bytes_per_app(1, 1, 60)
    assert one == 8 + 260 + 29
    assert sim._state_bytes_per_app(32, 1, 60) == 8 + 260 + 32 * 29
    assert sim._auto_chunk([band(_single)]) == sim.DEFAULT_APP_CHUNK
    assert sim._auto_chunk([band(_grid32)]) == sim.DEFAULT_APP_CHUNK // 5
    assert sim._auto_chunk([band(_single), band(_two_groups)]) == \
        sim.DEFAULT_APP_CHUNK // 4
    # past 256 bins the kernel engine expands to a histogram per config
    assert sim._auto_chunk([band(_columns)]) == sim.DEFAULT_APP_CHUNK // 4


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_factored_scan_equals_factored_plain_scan():
    """Every form from a block: the factored kernel (2 and 8 bins a lane,
    one and two configs a lane, a split group, two groups) and the
    expanded forms, from the initial carry and a mid-trace state, against
    the factored plain scan on the CPU; ``torch.equal`` on all ten
    outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    wide240 = lambda mod: [mod.HybridSpec(cv_threshold=cv, margin=m,
                                          use_arima=False)
                           for cv in (0.5, 1.0, 2.0) for m in (0.1, 0.2)]
    grids = dict(SCAN_GRIDS, wide240=wide240)
    seen = set()
    for grid, make in sorted(grids.items()):
        for mid_trace in (False, True):
            cfgs, blk, n_bins, cols, state = _scan_case(grid, mid_trace,
                                                        n=301, make=make)
            ids = sim._sweep_identities(blk)
            want = H.fused_hybrid_sweep_scan_factored_plain(
                cols, *[x.clone() for x in state], blk=blk, ids=ids)
            gblk = pm.HybridSweepBlock(*(x.to(dev) for x in blk))
            plan = H.factored_scan_plan(blk, ids, n_bins, dev)
            before = dict(H.SCAN_LAUNCHES_BY_FORM)
            got = H.fused_hybrid_sweep_scan_factored(
                cols.to(dev), *[x.to(dev) for x in state], blk=gblk,
                ids=ids, plan=plan)
            torch.cuda.synchronize()
            assert H.SCAN_LAUNCHES_BY_FORM[plan.form] == \
                before[plan.form] + 1
            seen.add((plan.form, plan.bins_per_lane, plan.configs_per_lane))
            for name, g, w in zip(STATE, got, want):
                assert torch.equal(g.cpu(), w), (grid, mid_trace, name)
    assert {("factored", 2, 1), ("factored", 2, 2), ("factored", 8, 1),
            ("registers", 2, 0), ("columns", 0, 0)} <= seen
