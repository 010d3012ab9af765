"""The port's runtime ``Config`` (``config.py``) and its profiler ranges
(``obs/spans.py``) against the reference's ``Config``, ``get_config``,
``set_config`` and ``obs.set_enabled``.

- the fields the port keeps, their knobs and defaults;
- ``set_config`` raising on an unknown key, winning over the environment
  until ``reset_config``, and the environment read anew at each access
  otherwise (the port's tests set knobs with ``monkeypatch.setenv``);
- the switches changing the port's behaviour as they change the
  reference's: ``metrics_enabled`` (``run_fused`` emits a report, and
  ``obs.set_enabled(False)`` stops it), ``control_plane_enabled`` (the
  executor builds a control plane), ``trace_export`` (reports written
  there);
- ``trace_enabled``: ``srt::<name>`` ``record_function`` ranges in a
  ``torch.profiler`` trace with the switch on, none with it off.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spark_rapids_jni_tpu import config as ref_config
from spark_rapids_jni_tpu import obs as ref_obs
from spark_rapids_jni_tpu.tpcds import queries as RQ
from spark_rapids_jni_tpu.tpcds.rel import rel_from_df as ref_rel_from_df
from spark_rapids_jni_tpu.tpcds.rel import run_fused as ref_run_fused

from spark_rapids_jni_tpu_torch import config, obs
from spark_rapids_jni_tpu_torch.obs import spans
from spark_rapids_jni_tpu_torch.serving import QueryExecutor
from spark_rapids_jni_tpu_torch.tpcds import PLANS, generate
from spark_rapids_jni_tpu_torch.tpcds.rel import rel_from_df, run_fused

CPU = "cpu"
KNOBS = {"trace_enabled": "SRT_TRACE_ENABLED", "metrics_enabled":
         "SRT_METRICS", "trace_export": "SRT_TRACE_EXPORT",
         "control_plane_enabled": "SRT_CONTROL_PLANE"}
# no port code would read these (the module docstring says why)
LEFT_OUT = {"use_pallas", "shape_bucket_floor", "refcount_debug",
            "memory_log_level"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in KNOBS.values():
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.delenv("SRT_RESULT_CACHE_BYTES", raising=False)
    config.reset_config()
    obs.reset_all()
    yield
    config.reset_config()
    obs.reset_all()


@pytest.fixture(scope="module")
def data():
    return generate(sf=0.3, seed=7)


def _names(prof) -> list:
    return [e.name for e in prof.events()]


def test_fields_knobs_and_defaults_match_reference(monkeypatch):
    import dataclasses
    ref_fields = {f.name for f in dataclasses.fields(ref_config.Config)}
    assert set(KNOBS) == ref_fields - LEFT_OUT
    fresh = ref_config.Config()  # the reference reads the env at build
    cfg = config.get_config()
    for name in KNOBS:
        assert getattr(cfg, name) == getattr(fresh, name), name
    for name, knob, value, want in (
            ("metrics_enabled", "SRT_METRICS", "1", True),
            ("trace_enabled", "SRT_TRACE_ENABLED", "yes", True),
            ("trace_export", "SRT_TRACE_EXPORT", "/x", "/x"),
            ("control_plane_enabled", "SRT_CONTROL_PLANE", "true", True)):
        monkeypatch.setenv(knob, value)
        assert getattr(ref_config.Config(), name) == want
        assert getattr(cfg, name) == want, name  # read anew, no rebuild
    for name in LEFT_OUT:
        with pytest.raises(AttributeError):
            getattr(cfg, name)
        with pytest.raises(AttributeError, match="unknown config key"):
            config.set_config(**{name: 1})


@pytest.mark.parametrize("cfg", [config, ref_config],
                         ids=["port", "reference"])
def test_unknown_key_raises(cfg):
    with pytest.raises(AttributeError, match="unknown config key"):
        cfg.set_config(no_such_knob=True)


def test_set_config_wins_until_reset(monkeypatch):
    cfg = config.get_config()
    monkeypatch.setenv("SRT_METRICS", "1")
    config.set_config(metrics_enabled=False, trace_export="/a")
    assert not cfg.metrics_enabled and not config.metrics_enabled()
    assert cfg.trace_export == "/a"
    monkeypatch.setenv("SRT_METRICS", "0")
    monkeypatch.setenv("SRT_TRACE_EXPORT", "/b")
    config.reset_config("metrics_enabled")
    assert not cfg.metrics_enabled and cfg.trace_export == "/a"
    monkeypatch.setenv("SRT_METRICS", "1")
    assert cfg.metrics_enabled  # the environment again, read anew
    config.reset_config()
    assert cfg.trace_export == "/b"
    cfg.trace_enabled = True  # attribute assignment goes to set_config
    assert config.get_config().trace_enabled


def test_set_config_metrics_makes_run_fused_report(data):
    """With ``SRT_METRICS`` unset, ``set_config(metrics_enabled=True)``
    makes both packages' ``run_fused`` emit a report; ``set_enabled
    (False)`` turns them off again."""
    rels = {k: rel_from_df(v, device=CPU) for k, v in data.items()}
    ref_rels = {k: ref_rel_from_df(v) for k, v in data.items()}
    saved = ref_config.get_config().metrics_enabled
    try:
        for on in (True, False):
            obs.reset_reports()
            ref_obs.reset_reports()
            if on:
                config.set_config(metrics_enabled=True)
                ref_config.set_config(metrics_enabled=True)
            else:
                obs.set_enabled(False)
                ref_obs.set_enabled(False)
            run_fused(PLANS["q3"], rels, device=CPU)
            ref_run_fused(RQ._q3, ref_rels)
            got, want = obs.last_report("q3"), ref_obs.last_report("q3")
            assert (got is not None) == (want is not None) == on
            if on:
                assert got.fused and want.fused
                assert got.host_syncs == want.host_syncs == 1
    finally:
        ref_config.set_config(metrics_enabled=saved)
        ref_obs.reset_reports()


def test_set_enabled_gates_histograms():
    obs.set_enabled(True)
    obs.histogram("test.config.h").observe(5)
    obs.set_enabled(False)
    obs.histogram("test.config.h").observe(7)
    assert obs.histogram("test.config.h").snapshot()["count"] == 1


def test_set_config_control_plane_and_trace_export(data, tmp_path):
    config.set_config(control_plane_enabled=True)
    ex = QueryExecutor(device=CPU)
    try:
        assert ex._control is not None
    finally:
        ex.close(timeout=60)
    config.set_config(control_plane_enabled=False, metrics_enabled=True,
                      trace_export=str(tmp_path))
    ex = QueryExecutor(device=CPU)
    assert ex._control is None
    ex.close(timeout=60)
    rels = {k: rel_from_df(v, device=CPU) for k, v in data.items()}
    run_fused(PLANS["q1"], rels, device=CPU)
    written = sorted(tmp_path.glob("report_*_q1.json"))
    assert written and json.loads(written[-1].read_text())["query"] == "q1"


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_trace_export_none_reads_as_unset(data, pkg, tmp_path,
                                          monkeypatch):
    """``set_config(trace_export=None)`` (how the reference's own tests
    clear it) with metrics on: ``run_fused`` still emits its report,
    writes no file, and the flight recorder dumps to its default
    directory, in both packages."""
    from spark_rapids_jni_tpu.obs import flight as ref_flight
    from spark_rapids_jni_tpu_torch.obs import flight
    monkeypatch.chdir(tmp_path)
    if pkg == "port":
        cfg, o, fl = config, obs, flight
        rels = {k: rel_from_df(v, device=CPU) for k, v in data.items()}
        run = lambda: run_fused(PLANS["q1"], rels, device=CPU)  # noqa: E731
    else:
        cfg, o, fl = ref_config, ref_obs, ref_flight
        rels = {k: ref_rel_from_df(v) for k, v in data.items()}
        run = lambda: ref_run_fused(RQ._q1, rels)  # noqa: E731
    saved = ref_config.get_config()
    saved = (saved.metrics_enabled, saved.trace_export)
    try:
        cfg.set_config(metrics_enabled=True, trace_export=None)
        o.reset_reports()
        run()
        assert o.last_report("q1") is not None
        assert fl.dump_dir() == fl.DEFAULT_DUMP_DIR
        assert not list(tmp_path.rglob("report_*.json"))
    finally:
        ref_config.set_config(metrics_enabled=saved[0],
                              trace_export=saved[1])
        ref_obs.reset_reports()


@pytest.mark.parametrize("metrics", [False, True], ids=["plain", "metrics"])
def test_trace_ranges_only_with_the_switch(data, metrics):
    """Under ``torch.profiler`` on the CPU, ``srt::`` ranges appear with
    ``trace_enabled`` on (the query's spans and traced ops, nested in
    one another) and none with it off; the span ring records only with
    metrics on."""
    rels = {k: rel_from_df(v, device=CPU) for k, v in data.items()}
    run_fused(PLANS["q3"], rels, device=CPU)  # warm
    config.set_config(metrics_enabled=metrics)
    seen = {}
    for on in (True, False):
        config.set_config(trace_enabled=on)
        mark = spans.mark()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run_fused(PLANS["q3"], rels, device=CPU)
        seen[on] = [n for n in _names(prof) if n.startswith("srt::")]
        assert bool(spans.records_since(mark)) == metrics
    assert not seen[False]
    assert "srt::rel.fused_program" in seen[True], sorted(set(seen[True]))
    assert len(set(seen[True])) > 1


def test_traced_op_opens_a_range():
    @obs.traced("test.config.op")
    def op(x):
        return x + 1

    config.set_config(trace_enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert int(op(torch.ones(1))) == 2
    events = [e for e in prof.events() if e.name == "srt::test.config.op"]
    assert len(events) == 1
    assert any(c.name == "aten::add" for c in events[0].cpu_children)
    config.set_config(trace_enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        op(torch.ones(1))
    assert "srt::test.config.op" not in _names(prof)
