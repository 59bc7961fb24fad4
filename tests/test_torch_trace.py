"""PyTorch port, the tracer (utils/trace.py): off, it records nothing and a
NUTS transition reads none of its clock; on, the draws, log-densities and
NutsStats are the bits of a run with it off; each transition's spans nest
(one prologue, one launch and readout per doubling run, one stats) and its
readouts count the tree's lockstep leaves; self times are not negative and
every parent encloses its children; solve_magi's phase spans sum to its
total time within 1%; the warmups' spans come once per transition and
chunk; the report's device arithmetic (graph and eager time, the gaps,
idle time by the innermost host span, the stage sums and readings) holds
on a synthetic timeline and stamp buffer. On a card (tests marked
``cuda``): the stages the doubling's kernels stamp inside a replayed graph
(WHILE bodies included) sum to the replays' event spans within 3%, and the
graphs captured with the tracer on have the node counts of those captured
with it off and draw the same bits. Small FN problem, float64 on the CPU."""
import numpy as np
import pytest
import torch

import manifold_constrained_gaussian_process_inference_tpu_torch as mt
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import (
    nuts_batched as nb,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import whiten
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.adapt import (
    build_window_schedule,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts import (
    ChainState,
    DenseMetric,
    SampleCarry,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import chains
from manifold_constrained_gaussian_process_inference_tpu_torch.utils import trace

torch.set_num_threads(1)

STATS = ("accept_prob", "num_leapfrog", "tree_depth", "diverging", "energy", "step_size")
BASE = dict(niter_hmc=24, seed=3, sigma=[0.2, 0.2], phi=np.array([[1.0, 1.0], [1.5, 1.5]]),
            x_whitened=True, device="cpu", n_chains=3, mass_matrix="dense-pooled",
            chunk_size=4, max_tree_depth=6)


def _data():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 4, 9)
    y = np.stack([np.sin(t), np.cos(t)], -1) + 0.2 * rng.normal(size=(9, 2))
    return y, t


@pytest.fixture(autouse=True)
def tracer():
    """Every test starts and ends with the tracer off and empty."""
    trace.stop()
    trace.TRACER._clear()
    yield trace.TRACER
    trace.stop()
    trace.TRACER._clear()


@pytest.fixture(scope="module")
def solved():
    y, t = _data()
    return mt.solve_magi(y, t, mt.FN_SYSTEM, mt.MagiConfig(**BASE))


@pytest.fixture(scope="module")
def fn_state(solved):
    """The whitened FN value-and-grad, the chains' last state, their step
    sizes and the pooled metric of the solved run."""
    d = solved.diagnostics
    vg = whiten.make_centered_whitened_vg(d["target"], d["whitener"])
    q = torch.as_tensor(d["final_psi"])
    metric = DenseMetric(*chains.dense_metric_from_minv(d["inv_mass"], torch.float64, "cpu"))
    return vg, q, torch.as_tensor(d["step_size"]), metric


def _transitions(fn_state, n, seed=11):
    """n sampling transitions from the solved state: [(q, logp, stats)]."""
    vg, q, eps, metric = fn_state
    gen = torch.Generator().manual_seed(seed)
    step = nb.make_sample_step_batched(vg, BASE["max_tree_depth"], gen)
    logp, grad = vg(q)
    carry = SampleCarry(chain=ChainState(q=q, logp=logp, grad=grad), eps=eps)
    out = []
    for _ in range(n):
        carry, drawn = step(carry, None, metric)
        out.append(drawn)
    return out


def test_off_records_nothing_and_the_transition_reads_no_clock(fn_state, monkeypatch):
    calls = []
    real = trace.clock
    monkeypatch.setattr(trace, "clock", lambda: calls.append(1) or real())
    _transitions(fn_state, 3)
    assert calls == [] and trace.TRACER.spans == [] and trace.report() == {}
    for make in (trace.span, trace.device_span, trace.section):
        assert make("x") is trace.NO_SPAN
    assert trace.stage(trace.VG) is trace.NO_SPAN
    assert trace.take_stage(torch.device("cpu")) == (None, 0, 0)
    trace.start()
    _transitions(fn_state, 1)
    assert calls and trace.TRACER.spans


def test_draws_and_stats_are_the_same_bits_on_and_off(fn_state):
    off = _transitions(fn_state, 5)
    trace.start()
    on = _transitions(fn_state, 5)
    trace.stop()
    for (q0, lp0, s0), (q1, lp1, s1) in zip(off, on):
        assert torch.equal(q0, q1) and torch.equal(lp0, lp1)
        for name in STATS:
            assert torch.equal(getattr(s0, name), getattr(s1, name)), name
        assert (s0.host_syncs, s0.lockstep_leaves) == (s1.host_syncs, s1.lockstep_leaves)


def test_solve_magi_draws_the_same_bits_with_the_tracer_on(solved):
    y, t = _data()
    trace.start()
    res = mt.solve_magi(y, t, mt.FN_SYSTEM, mt.MagiConfig(**BASE))
    trace.stop()
    np.testing.assert_array_equal(res.theta, solved.theta)
    np.testing.assert_array_equal(res.lp, solved.lp)
    np.testing.assert_array_equal(res.diagnostics["final_psi"], solved.diagnostics["final_psi"])


def test_transition_spans_nest_and_count_the_lockstep_leaves(fn_state):
    trace.start()
    drawn = _transitions(fn_state, 6)
    spans = trace.TRACER.spans
    by_index = {sp.index: sp for sp in spans}
    for t, (_, _, stats) in enumerate(drawn):
        mine = [sp for sp in spans if sp.transition == t]
        (top,) = [sp for sp in mine if sp.name == "transition"]
        assert by_index[top.parent].name == "sample_step"
        children = [sp.name for sp in mine if sp.parent == top.index]
        doublings = int(stats.tree_depth.max())
        # the CPU's eager doublings: no launch tables to keep
        assert children == (["transition.prologue"]
                            + ["doubling.launch", "doubling.readout"] * doublings
                            + ["transition.stats"])
        assert sum(sp.n for sp in mine if sp.name == "doubling.readout") \
            == stats.lockstep_leaves
    assert all(sp.transition == -1 for sp in spans if sp.name == "sample_step")
    rep = trace.report()
    assert rep["spans"]["doubling.readout"]["counted"] == sum(s.lockstep_leaves
                                                             for _, _, s in drawn)
    assert rep["sections"]["all"]["transitions"] == 6


def test_self_times_are_not_negative_and_parents_enclose_children(solved):
    y, t = _data()
    trace.start()
    mt.solve_magi(y, t, mt.FN_SYSTEM, mt.MagiConfig(**BASE))
    trace.stop()
    spans = trace.TRACER.spans
    for sp in spans:
        assert sp.end >= sp.start
        if sp.parent >= 0:
            parent = spans[sp.parent]
            assert parent.start <= sp.start and sp.end <= parent.end, (parent.name, sp.name)
    for name, e in trace.report()["spans"].items():
        assert 0 <= e["self_s"] <= e["total_s"] + 1e-12, name


def test_phase_spans_sum_to_the_total_time(solved):
    d = solved.diagnostics
    phases = d["phase_times_s"]
    assert set(phases) == {"nlml_s", "gp_target_s", "gn_map_s", "whitener_s",
                           "sampler_setup_s", "warmup_s", "sampling_s", "results_s"}
    assert min(phases.values()) >= 0
    assert abs(sum(phases.values()) - d["total_time_s"]) <= 0.01 * d["total_time_s"]
    # on, the same phases are spans (the sampler's warmup and sampling its own)
    y, t = _data()
    trace.start()
    res = mt.solve_magi(y, t, mt.FN_SYSTEM, mt.MagiConfig(**BASE))
    names = trace.report()["spans"]
    for key in res.diagnostics["phase_times_s"]:
        name = key.removesuffix("_s") if key in ("warmup_s", "sampling_s") else \
            "phase." + key.removesuffix("_s")
        assert names[name]["count"] == 1, name
    assert names["warmup"]["total_s"] == pytest.approx(
        res.diagnostics["phase_times_s"]["warmup_s"], abs=1e-3)


@pytest.mark.parametrize("mass_matrix", ["dense-pooled", "diag"])
def test_warmup_spans_come_once_per_transition_and_chunk(tmp_path, mass_matrix):
    y, t = _data()
    config = mt.MagiConfig(**{**BASE, "mass_matrix": mass_matrix},
                           checkpoint_path=str(tmp_path / "ck.npz"))
    n_adapts = int(np.floor(config.niter_hmc * config.burnin_ratio))
    in_window, window_end = build_window_schedule(n_adapts)
    if mass_matrix == "diag":
        chunks = chains._chunk_lengths(n_adapts, config.chunk_size)
    else:
        chunks = chains._window_aligned_chunks(window_end, config.chunk_size)
    trace.start()
    mt.solve_magi(y, t, mt.FN_SYSTEM, config)
    rep = trace.report()
    counts = {name: e["count"] for name, e in rep["spans"].items()}
    assert counts["warmup.transition"] == n_adapts
    assert counts["warmup.moments"] == int(in_window.sum())
    assert counts["warmup.refit"] == int(window_end.sum())
    assert counts["warmup.readout"] == len(chunks)
    assert counts.get("warmup.checkpoint", 0) == (len(chunks) if mass_matrix != "diag" else 0)
    assert counts["transition"] == config.niter_hmc
    assert 0 < rep["warmup_adapt_s"] < rep["spans"]["warmup"]["total_s"]


def _timeline(tracer):
    """Two sampling transitions on a synthetic clock (ns), the second inside
    a section: device spans with event times of their own."""
    tracer.start(device="cpu")
    plan = []  # (span, host start, host end, device stretch or None)

    def rec(sp, a, b, dev=None, n=0):
        plan.append((sp, a, b, dev))
        if n:
            sp.count(n)

    def transition(t0, graphs, readouts, stats_dev, prologue_dev):
        with tracer.span("sample_step") as s, tracer.span("transition") as tr:
            with tracer.device_span("transition.prologue") as p:
                rec(p, t0 + 10, t0 + 50, prologue_dev)
            for (a, b, dev), (ra, rb, leaves) in zip(graphs, readouts):
                with tracer.device_span("doubling.launch", "graph") as g:
                    rec(g, a, b, dev)
                with tracer.span("doubling.readout") as r:
                    rec(r, ra, rb, n=leaves)
                with tracer.span("doubling.bookkeeping") as k:
                    rec(k, rb, rb + 5)
            with tracer.device_span("transition.stats") as st:
                rec(st, readouts[-1][1] + 5, readouts[-1][1] + 25, stats_dev)
        return s, tr

    s, tr = transition(10, [(60, 70, (70, 200)), (210, 220, (220, 400))],
                       [(70, 205, 1), (220, 405, 2)], (415, 440), (30, 70))
    rec(s, 10, 480)
    rec(tr, 20, 470)
    with tracer.section("window") as w:
        s, tr = transition(500, [(560, 570, (570, 900))], [(570, 905, 2)], (915, 940),
                           (520, 560))
    rec(w, 500, 980)
    rec(s, 500, 980)
    rec(tr, 510, 970)
    tracer.stop()
    dev = {}
    for sp, a, b, stretch in plan:
        sp.start, sp.end = a, b
        if stretch is not None:
            dev[sp.index] = stretch
    tracer.t_start, tracer.t_stop = 0, 1000
    tracer._device_times = lambda: dev
    return tracer.report()


def test_report_splits_a_synthetic_timeline(tracer):
    rep = _timeline(tracer)
    sec = rep["sections"]["all"]
    ns = 1e-9
    assert (sec["transitions"], sec["doublings"], sec["leaves"], sec["replays"]) == (2, 3, 5, 3)
    assert sec["busy_s"] == pytest.approx(640 * ns) and sec["eager_s"] == pytest.approx(130 * ns)
    assert (sec["doubling_gaps"], sec["transition_gaps"]) == (1, 1)
    assert sec["doubling_gap_s"] == pytest.approx(20 * ns)
    assert sec["transition_gap_s"] == pytest.approx(170 * ns)
    assert sec["transition_gap_eager_s"] == pytest.approx(65 * ns)
    assert sec["transition_gap_idle_s"] == pytest.approx(105 * ns)
    # busy + gaps run from the first graph's start to the last one's end
    assert sec["busy_s"] + sec["doubling_gap_s"] + sec["transition_gap_s"] == pytest.approx(
        (900 - 70) * ns)
    assert sec["idle_s"] == pytest.approx((1000 - 640 - 130) * ns)
    want = {"caller": 50, "sample_step": 40, "transition.prologue": 20, "doubling.readout": 15,
            "doubling.bookkeeping": 15, "doubling.launch": 20, "transition.stats": 10,
            "transition": 60}
    assert sec["idle_by_span"] == pytest.approx({k: v * ns for k, v in want.items()})
    assert sec["metrics"] == pytest.approx({
        "doubling_gap_ms": 20e-6, "transition_gap_ms": 170e-6,
        "transition_gap_eager_ms": 65e-6, "transition_gap_idle_ms": 105e-6})
    win = rep["sections"]["window"]
    assert (win["transitions"], win["replays"], win["transition_gaps"]) == (1, 1, 0)
    assert win["wall_s"] == pytest.approx(480 * ns)
    assert win["idle_s"] == pytest.approx((480 - 330 - 65) * ns)
    assert sum(win["idle_by_span"].values()) == pytest.approx(win["idle_s"])
    assert "caller" not in win["idle_by_span"]


def test_stage_readings_per_leaf_and_per_doubling():
    stages = {name: {"s": 0.0, "hits": 0} for name in trace.STAGES}
    for name, s, hits in (("open", 3e-6, 3), ("vg", 50e-6, 5), ("metric", 10e-6, 5),
                          ("commit", 5e-6, 5), ("merge", 6e-6, 3)):
        stages[name] = {"s": s, "hits": hits}
    sec = {"doubling_gaps": 0, "transition_gaps": 0}
    got = trace._readings(sec, stages, {})
    assert got == pytest.approx({"vg_in_tree_ms": 0.01, "metric_in_tree_ms": 0.002,
                                 "commit_in_tree_ms": 0.001, "doubling_ends_ms": 0.003})
    # a stage no kernel stamped is merged into the one before it, and not read
    assert "metric_in_tree_ms" not in trace._readings(sec, stages, {"metric": "vg"})
    tr = trace.Tracer()
    tr.stamped = {trace.OPEN, trace.COMMIT, trace.MERGE}
    assert tr.merged() == {"vg": "commit", "metric": "commit"}
    tr.stamped.add(trace.VG)
    assert tr.merged() == {"metric": "vg"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc; run on the card")
    return torch.device("cuda")


def _gaussian_tree(device, max_depth, seed=0, gemms=8):
    """A tree over a standard normal in 799 dimensions at 128 chains under an
    identity dense metric (its product is the port's kernel), whose
    value-and-grad also runs ``gemms`` products by the identity (exact), so
    that a leaf is long beside a replay's launch; at a step of 1e-3 no chain
    turns within 2^10 leaves."""
    c, dim = 128, 799
    gen = torch.Generator(device=device).manual_seed(seed)
    eye = torch.eye(dim, device=device)

    def vg(q):
        x = q
        for _ in range(gemms):
            x = x @ eye
        return -0.5 * (x * x).sum(-1), -x

    metric = DenseMetric(minv=eye, chol_minv=eye, p_chol=eye)
    q = torch.randn((c, dim), generator=gen, device=device)
    return nb.LockstepTree(vg, gen, max_depth), q, vg, metric


@pytest.mark.cuda
def test_cuda_stage_stamps_sum_to_the_replays_event_spans(cuda_device):
    tree, q, vg, metric = _gaussian_tree(cuda_device, 10)
    trace.start()
    lp, g = vg(q)
    tree(q, lp, g, 1e-3, metric)  # captures every depth, stamped
    with trace.section("replays"):
        out = tree(q, lp, g, 1e-3, metric)
    rep = trace.report()
    sec = rep["sections"]["replays"]
    stages = sec["stages"]
    inside = sum(stages[name]["s"] for name in ("open", "vg", "metric", "commit", "merge"))
    assert sec["replays"] == 10 == sec["doublings"]
    assert abs(inside - sec["busy_s"]) <= 0.03 * sec["busy_s"], (inside, sec["busy_s"])
    assert sec["replay_outside_stages_s"] == pytest.approx(sec["busy_s"] - inside)
    assert stages["commit"]["hits"] == stages["metric"]["hits"] == sec["leaves"] == \
        out[3].lockstep_leaves == 1023
    assert stages["open"]["hits"] == stages["merge"]["hits"] == 10
    assert rep["merged"] == {"vg": "commit"}  # the Gaussian's value-and-grad is torch's


@pytest.mark.cuda
def test_cuda_graphs_keep_their_nodes_and_draws_with_the_tracer_on(cuda_device):
    outs, infos = [], []
    for on in (False, True):
        if on:
            trace.start()
        tree, q, vg, metric = _gaussian_tree(cuda_device, 5, seed=1, gemms=1)
        bound = tree._bind(q, 0.3, metric)
        for i in range(tree.max_depth):
            tree.graphs[i] = tree._capture(bound, i)
        lp, g = vg(q)
        outs.append([tree(q, lp, g, 0.3, metric) for _ in range(2)])
        infos.append({i: (info["nodes"], info["body_nodes"], info["while_nodes"])
                      for i, info in tree.graph_info.items()})
        trace.stop()
    assert infos[0] == infos[1] and len(infos[0]) == 5
    for a, b in zip(*outs):
        for x, y in zip(a[:3], b[:3]):
            assert torch.equal(x, y)
        for name in STATS:
            assert torch.equal(getattr(a[3], name), getattr(b[3], name)), name


def test_kernel_sources_stamp_the_tracers_stages():
    """The stage ids and the buffer's layout the CUDA sources stamp are the
    tracer's."""
    import re

    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import leaf, minv_mv

    src = leaf.SOURCE.read_text()
    consts = dict(re.findall(r"(kStage[A-Z]\w*) = (\d+)", src))
    assert {k: int(v) for k, v in consts.items()} == {
        "kStageOpen": trace.OPEN, "kStageCommit": trace.COMMIT, "kStageMerge": trace.MERGE,
        "kStageBetween": trace.BETWEEN}
    assert re.search(rf"constexpr int kStages = {len(trace.STAGES)};", src)
    assert re.search(rf"constexpr int kTraceStages = {len(trace.STAGES)};",
                     minv_mv.SOURCE.read_text())
    for s in (src, minv_mv.SOURCE.read_text()):
        assert f"atomicAdd(b + {trace.SUMS} + prev, now);" in s
        assert f"atomicAdd(b + {trace.SUMS} + stage, 0ull - now);" in s
        assert re.search(rf"atomicAdd\(b \+ {trace.SUMS} \+ k\w*Stages \+ prev, 1ull\);", s)
        assert f"b[{trace.LAST}] = now;" in s
    assert leaf.OPEN_POINTERS[-1] == leaf.COMMIT_POINTERS[-1] == leaf.MERGE_POINTERS[-1] \
        == "trace"


def test_stage_sums_close_the_open_stage_and_drop_the_first_close():
    """The kernels' stamp arithmetic, replayed on the host: each stamp
    closes the stage before it (adds its time, counts it) and opens its
    own (subtracts its time). A copy of the buffer taken between stamps
    reads each stage's elapsed time, the stage still open adding nothing
    and the first stamp's close of between_graphs dropped."""
    k = len(trace.STAGES)
    buf = torch.zeros(trace.STAMP_WORDS, dtype=torch.int64)

    def stamp(t, prev, stage, mark=True, first=False):
        if first and buf[trace.FIRST] == 0:
            buf[trace.FIRST] = t
        buf[trace.SUMS + prev] += t
        buf[trace.SUMS + stage] -= t
        buf[trace.SUMS + k + prev] += 1
        if mark:
            buf[trace.LAST], buf[trace.CURRENT] = t, stage

    def doubling(t0, leaves):
        stamp(t0, trace.BETWEEN, trace.OPEN, first=True)
        t, prev = t0 + 3, trace.OPEN
        for _ in range(leaves):
            stamp(t, prev, trace.VG)
            stamp(t + 70, trace.VG, trace.METRIC)
            stamp(t + 80, trace.METRIC, trace.COMMIT)
            t, prev = t + 87, trace.COMMIT
        stamp(t, trace.COMMIT, trace.MERGE, mark=False)
        stamp(t + 4, trace.MERGE, trace.BETWEEN)
        return t + 4

    tr = trace.Tracer()
    end = doubling(1_000_000, 2)
    snap = buf.clone()
    doubling(end + 50, 4)
    first = tr._stage_sums(None, snap)
    both = tr._stage_sums(snap, buf.clone())
    assert {n: round(v["s"] * 1e9) for n, v in first.items()} == {
        "open": 3, "vg": 140, "metric": 20, "commit": 14, "merge": 4, "between_graphs": 0}
    assert {n: v["hits"] for n, v in first.items()} == {
        "open": 1, "vg": 2, "metric": 2, "commit": 2, "merge": 1, "between_graphs": 0}
    assert {n: round(v["s"] * 1e9) for n, v in both.items()} == {
        "open": 3, "vg": 280, "metric": 40, "commit": 28, "merge": 4, "between_graphs": 50}
    assert {n: v["hits"] for n, v in both.items()} == {
        "open": 1, "vg": 4, "metric": 4, "commit": 4, "merge": 1, "between_graphs": 1}
