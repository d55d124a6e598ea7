"""The serving launcher's obs flags on the CPU (the reference's
``--metrics-json``, ``--trace-out`` and ``--metrics-port``).

``launch/serve.py --engine --metrics-json --trace-out`` writes a metrics
file (the engine's registry and ``repro_torch.obs.REGISTRY``) and a
Chrome trace that parse and agree with the run; ``--metrics-port 0``
serves Prometheus text on 127.0.0.1 that holds both registries while the
engine runs; ``python -m repro_torch.obs --device cpu`` passes and writes
both artifacts.
"""

import json
import urllib.request

import numpy as np

from repro_torch.launch import serve
from repro_torch.serve import ServeEngine

SERVE = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
         "--batch", "3", "--prompt-len", "16", "--max-new", "4", "--engine"]


def test_metrics_json_and_trace_out(tmp_path, capsys):
    m, t = str(tmp_path / "metrics.json"), str(tmp_path / "trace.json")
    res = serve.main(SERVE + ["--metrics-json", m, "--trace-out", t])
    assert sorted(res) == [0, 1, 2]
    out = capsys.readouterr().out
    assert m in out and t in out
    with open(m) as f:
        metrics = json.load(f)
    assert sorted(metrics) == ["engine", "global"]
    eng = metrics["engine"]
    assert eng["counters"]['serve_requests_total{status="OK"}'] == 3
    assert eng["counters"]["serve_tokens_emitted_total"] == sum(
        len(r.tokens) for r in res.values())
    h = eng["histograms"]["serve_decode_step_seconds"]
    assert h["count"] == 3 and h["buckets"][-1] == ["+Inf", 3]
    assert any(k.startswith("ff_dispatch_resolutions_total")
               for k in metrics["global"]["counters"])
    with open(t) as f:
        trace = json.load(f)
    evs = trace["traceEvents"]
    spans = [e for e in evs if e["ph"] == "X" and e["name"] == "request"]
    assert sorted(e["args"]["uid"] for e in spans) == [0, 1, 2]
    assert all(e["args"]["status"] == "OK" for e in spans)
    ts = [e["ts"] for e in evs if e["ph"] != "M"]
    assert ts == sorted(ts) and min(ts) >= 0


def test_metrics_port_serves_both_registries(monkeypatch, capsys):
    """--metrics-port 0 takes a free port; the page is fetched while the
    server is up (right after the engine's run, before the launcher shuts
    it down)."""
    pages, servers = [], []
    start = serve._start_metrics_server

    def spy_start(observer, port):
        srv = start(observer, port)
        servers.append(srv)
        return srv

    run = ServeEngine.run

    def run_and_scrape(self, **kw):
        res = run(self, **kw)
        port = servers[-1].server_address[1]
        for path in ("/metrics", "/"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=30) as r:
                pages.append((r.status, r.headers["Content-Type"],
                              r.read().decode()))
        return res

    monkeypatch.setattr(serve, "_start_metrics_server", spy_start)
    monkeypatch.setattr(ServeEngine, "run", run_and_scrape)
    res = serve.main(SERVE + ["--metrics-port", "0"])
    assert sorted(res) == [0, 1, 2]
    assert "metrics: http://127.0.0.1:" in capsys.readouterr().out
    assert len(pages) == 2 and pages[0][2] == pages[1][2]
    status, ctype, text = pages[0]
    assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
    assert 'serve_requests_total{status="OK"} 3' in text
    assert "# TYPE serve_guard_events_total counter" in text
    assert "# TYPE ff_dispatch_resolutions_total counter" in text
    assert "# TYPE serve_decode_step_seconds histogram" in text
    for line in text.splitlines():
        assert line.startswith("#") or len(line.rsplit(" ", 1)) == 2
    # the launcher shut the server down after the run
    try:
        urllib.request.urlopen(
            f"http://127.0.0.1:{servers[-1].server_address[1]}/metrics",
            timeout=5)
        up = True
    except OSError:
        up = False
    assert not up
    assert np.isfinite(np.concatenate([r.logprobs for r in res.values()])
                       ).all()


def test_obs_smoke_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.obs --device cpu``: every check passes and
    both artifacts parse (the explicit Ozaki matmul in the telemetry)."""
    from repro_torch.obs.__main__ import main
    m, t = str(tmp_path / "m.json"), str(tmp_path / "t.json")
    assert main(["--device", "cpu", "--metrics-json", m,
                 "--trace-out", t]) == 0
    out = capsys.readouterr().out
    assert "obs smoke: all checks passed" in out and "[FAIL]" not in out
    assert "ff.matmul: ozaki (explicit)" in out
    with open(m) as f:
        metrics = json.load(f)
    assert metrics["engine"]["counters"][
        'serve_requests_total{status="OK"}'] == 4
    with open(t) as f:
        assert len([e for e in json.load(f)["traceEvents"]
                    if e["ph"] == "X" and e["name"] == "request"]) == 4
