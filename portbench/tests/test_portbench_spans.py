"""``spans.py`` and its readers on hand-written Kineto-shaped events:
nested ``user_annotation`` spans on one host thread, runtime launches with
``correlation``, kernels and memsets on two streams (times in µs)."""
import pytest

from portbench import harness, spans
from portbench.trace import Trace

READERS = ("executor_idle_share", "dispatch_idle_share", "host_sync_idle_share",
           "decode_host_syncs", "prefill_corun_ms", "decode_corun_ms", "cache_init_ms")
HOST = 10


class Events:
    def __init__(self):
        self.events, self.corr = [], 0

    def span(self, name, a, b, tid=HOST):
        self.events.append({"ph": "X", "cat": "user_annotation", "name": name, "pid": 1,
                            "tid": tid, "ts": a, "dur": b - a})

    def launch(self, at, a, b, stream=7, cat="kernel", tid=HOST):
        self.corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                            "pid": 1, "tid": tid, "ts": at, "dur": 0.5,
                            "args": {"correlation": self.corr}})
        self.events.append({"ph": "X", "cat": cat, "name": f"work{self.corr}", "pid": 0,
                            "tid": stream, "ts": a, "dur": b - a,
                            "args": {"correlation": self.corr}})


def macro_step(harness_spans=True) -> Events:
    """One macro-step over [10, 200]: a prefill step whose cache init
    launches a memset and a fill kernel, a decode step with two host syncs
    inside its ``moe`` span, the barrier; and a kernel another thread
    launched."""
    ev = Events()
    ev.span("executor.macro_step", 10, 200)
    if harness_spans:
        ev.span("portbench:prefill", 11, 90)
        ev.span("portbench:decode", 90, 150)
    ev.span("step.prefill", 12, 80)
    ev.span("kv_cache.init", 13, 20)
    ev.launch(14, 30, 34, cat="gpu_memset")
    ev.launch(15, 34, 40)
    ev.launch(25, 40, 70)
    ev.launch(50, 70, 75)
    ev.span("step.decode", 91, 140)
    ev.span("moe", 92, 130)
    ev.launch(93, 95, 100, stream=8)
    ev.span("moe.host_sync", 101, 110)
    ev.launch(111, 112, 118, stream=8)
    ev.span("moe.host_sync", 119, 125)
    ev.launch(131, 133, 137, stream=8)
    ev.span("executor.barrier", 150, 190)
    ev.launch(155, 160, 170, stream=9, tid=HOST + 1)
    return ev


# busy: [34, 75], [95, 100], [112, 118], [133, 137], [160, 170] = 66 of 200
# idle [0, 34]:    outside 10, executor 2 (10-12), dispatch 22
# idle [75, 95]:   dispatch 5 (75-80), executor 11 (80-91), dispatch 4
# idle [100, 112]: dispatch 1, host_sync 9 (101-110), dispatch 2
# idle [118, 133]: dispatch 1, host_sync 6 (119-125), dispatch 8
# idle [137, 160], [170, 200]: dispatch 3 (137-140), executor 20 + 30
EXPECTED = {"outside": 10, "executor": 63, "dispatch": 46, "host_sync": 15}


def ctx_of(ev: Events, wall_us: float = 200) -> dict:
    return {"trace": Trace(ev.events, wall_us / 1e6)}


def read(name: str, ctx: dict):
    return harness.reader(name)(ctx)


@pytest.mark.parametrize("harness_spans", [True, False], ids=["with_portbench", "without"])
@pytest.mark.parametrize("wall_us", [200, 260])
def test_owners_sum_to_the_idle_share(harness_spans, wall_us):
    ctx = ctx_of(macro_step(harness_spans), wall_us)
    sp = spans.of(ctx)
    total = sum(sp.idle_share(w) for w in spans.OWNERS)
    assert total == pytest.approx(1 - ctx["trace"].busy_s() / ctx["trace"].wall_s, abs=1e-12)
    # a longer wall reaches back before the macro-step, where only the harness runs
    want = dict(EXPECTED, outside=EXPECTED["outside"] + wall_us - 200)
    assert {w: sp.idle_us[w] for w in spans.OWNERS} == pytest.approx(want)
    assert read("executor_idle_share", ctx) == pytest.approx(want["executor"] / wall_us)
    assert read("dispatch_idle_share", ctx) == pytest.approx(want["dispatch"] / wall_us)
    assert read("host_sync_idle_share", ctx) == pytest.approx(want["host_sync"] / wall_us)


@pytest.mark.parametrize("step_end, barrier", [(50, (50, 100)), (30, (60, 100))])
def test_an_idle_interval_is_split_at_the_step_spans_end(step_end, barrier):
    ev = Events()
    ev.span("executor.macro_step", 0, 100)
    ev.span("step.decode", 0, step_end)
    ev.launch(1, 2, 10)
    ev.span("executor.barrier", *barrier)
    sp = spans.of(ctx_of(ev, 100))
    # idle [0, 2] and [10, 100]: dispatch until the step ends, the executor after
    assert sp.idle_us == pytest.approx({"dispatch": 2 + step_end - 10,
                                        "executor": 100 - step_end, "host_sync": 0,
                                        "outside": 0})


@pytest.mark.parametrize("where", ["inside_a_step", "outside_the_macro_step"])
def test_portbench_spans_are_ignored(where):
    ev = Events()
    ev.span("executor.macro_step", 20, 100)
    ev.span("step.prefill", 20, 100)
    ev.launch(21, 30, 40)
    if where == "inside_a_step":
        ev.span("portbench:prefill", 20, 100)
        ev.span("portbench:executor.barrier", 22, 100)
    else:
        ev.span("portbench:step.prefill", 0, 20)
    sp = spans.of(ctx_of(ev, 100))
    assert [s[2] for s in sp.spans] == ["executor.macro_step", "step.prefill"]
    assert sp.idle_us == pytest.approx({"outside": 20, "dispatch": 70, "executor": 0,
                                        "host_sync": 0})


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_without_the_programs_spans(name):
    ev = Events()                        # the harness's spans and kernels only
    ev.span("portbench:prefill", 0, 80)
    ev.launch(1, 2, 40)
    ev.span("portbench:decode", 80, 100)
    ev.launch(81, 82, 90, stream=8)
    assert read(name, ctx_of(ev, 100)) is None
    assert read(name, {}) is None        # an untraced run


@pytest.mark.parametrize("name, first, last", [("prefill_corun_ms", 34, 75),
                                               ("decode_corun_ms", 95, 137)])
def test_corun_ms_is_first_kernel_to_last_a_step(name, first, last):
    ev = macro_step()
    assert read(name, ctx_of(ev)) == pytest.approx((last - first) / 1e3)
    # a second instance of 100 us: the mean of the two
    ev.span(f"step.{name.split('_')[0]}", 300, 400)
    ev.launch(301, 310, 350)
    ev.launch(302, 350, 410, stream=8)
    assert read(name, ctx_of(ev, 410)) == pytest.approx((last - first + 100) / 2e3)


@pytest.mark.parametrize("extra", ["none", "init_outside_a_prefill"])
def test_cache_init_ms_counts_a_memset(extra):
    ev = macro_step()
    if extra == "init_outside_a_prefill":  # a cache made outside a prefill step
        ev.span("kv_cache.init", 141, 149)
        ev.launch(142, 143, 148, cat="gpu_memset")
    # the memset [30, 34] and the fill kernel [34, 40]
    assert read("cache_init_ms", ctx_of(ev)) == pytest.approx(10 / 1e3)


@pytest.mark.parametrize("second_step_syncs, want", [(None, 2.0), (0, 1.0), (3, 2.5)])
def test_decode_host_syncs_counts_instances(second_step_syncs, want):
    ev = macro_step()                    # a decode step with two host syncs
    if second_step_syncs is not None:
        ev.span("step.decode", 300, 400)
        for i in range(second_step_syncs):
            ev.span("moe.host_sync", 310 + 10 * i, 315 + 10 * i)
    ev.span("moe.host_sync", 410, 420)   # outside every decode step: not counted
    assert read("decode_host_syncs", ctx_of(ev, 420)) == pytest.approx(want)
