"""The port's wire and ingress — ``serve/wire.py``, ``serve/ingress.py`` and
``serve/loadgen.py`` — against the JAX package's, on the CPU (the twin of
``tests/test_wire.py`` and ``tests/test_ingress_v2.py``).

Inputs: seeded rows (numpy) and ``planted_prototypes`` streams of the JAX
package, 4 partitions, 50 rows a batch, 2 batches a chunk. The two
packages' clients and daemons must interoperate: the same rows encode to
the same bytes, the JAX package's ``run_loadgen`` drives the port daemon
over a loopback socket, and the port daemon's verdict records equal the
JAX daemon's on the same stream but for ``ts`` and ``lat_ms``. Tolerance:
none.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distributed_drift_detection_tpu import RunConfig as JRunConfig  # noqa: E402
from distributed_drift_detection_tpu.config import ServeParams as JServeParams  # noqa: E402
from distributed_drift_detection_tpu.io import planted_prototypes  # noqa: E402
from distributed_drift_detection_tpu.serve import ServeRunner as JServeRunner  # noqa: E402
from distributed_drift_detection_tpu.serve import loadgen as jloadgen  # noqa: E402
from distributed_drift_detection_tpu.serve import read_verdicts  # noqa: E402
from distributed_drift_detection_tpu.serve import wire as jwire  # noqa: E402
from distributed_drift_detection_tpu.telemetry.events import read_events  # noqa: E402
from distributed_drift_detection_tpu_torch import RunConfig  # noqa: E402
from distributed_drift_detection_tpu_torch.config import ServeParams  # noqa: E402
from distributed_drift_detection_tpu_torch.serve import ServeRunner  # noqa: E402
from distributed_drift_detection_tpu_torch.serve import loadgen as tloadgen  # noqa: E402
from distributed_drift_detection_tpu_torch.serve import wire as twire  # noqa: E402

P, B, CB = 4, 50, 2


def _rows(seed, n=37, f=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[3, 2] = np.nan
    return X, rng.integers(0, 5, size=n).astype(np.int32)


@pytest.mark.parametrize("what", ["v1_lines", "v2_frame", "v2_tenant_frame", "controls",
                                  "dirty_v1", "dirty_v2"])
def test_wire_bytes_equal_jax(what):
    """Both packages encode the same rows to the same bytes, and each
    decodes the other's frames to the same rows."""
    X, y = _rows(7)
    if what == "v1_lines":
        assert tloadgen.format_lines(X, y) == jloadgen.format_lines(X, y)
        return
    if what == "controls":
        for name in ("encode_flush", "encode_stop"):
            assert getattr(twire, name)() == getattr(jwire, name)()
        assert twire.encode_control(3, tenant=2) == jwire.encode_control(3, tenant=2)
        return
    if what.startswith("dirty"):
        spec = "nan_cell:4:3"
        if what == "dirty_v1":
            tl, jl = tloadgen.format_lines(X, y), jloadgen.format_lines(X, y)
            assert tloadgen.apply_dirty(tl, spec) == jloadgen.apply_dirty(jl, spec)
            assert tl == jl
        else:
            tX, ty, jX, jy = X.copy(), y.copy(), X.copy(), y.copy()
            assert (tloadgen.apply_dirty_frames(tX, ty, spec)
                    == jloadgen.apply_dirty_frames(jX, jy, spec))
            assert twire.encode_frame(tX, ty) == jwire.encode_frame(jX, jy)
        return
    tenant = 3 if what == "v2_tenant_frame" else 0
    t = twire.encode_frame(X, y, tenant=tenant)
    j = jwire.encode_frame(X, y, tenant=tenant)
    assert t == j
    for dec, buf in ((twire.decode_frame, j), (jwire.decode_frame, t)):
        hdr, fX, fy, used = dec(memoryview(buf))
        assert used == len(buf) and hdr.tenant == tenant and hdr.rows == len(y)
        np.testing.assert_array_equal(fX, X)
        np.testing.assert_array_equal(fy, y)


def _serve(runner):
    banner = runner.start()
    t = threading.Thread(target=runner.serve_forever)
    t.start()
    return banner, t


def _records(path):
    out = []
    for r in read_verdicts(path):
        r = dict(r)
        r.pop("ts")
        r.pop("lat_ms")
        out.append(r)
    return out


def _spans(log_path):
    """Span events without clocks, each id replaced by its span's name (span
    ids are drawn unseeded), so the chains' shapes compare."""
    spans = [e for e in read_events(log_path) if e["type"] == "span"]
    names = {e["span_id"]: e["name"] for e in spans}
    out = []
    for e in spans:
        e = {k: v for k, v in e.items() if k not in ("ts", "start_ts", "dur_s", "mono")}
        e["span_id"], e["parent_id"] = e["name"], names.get(e["parent_id"], e["parent_id"])
        out.append(json.dumps(e, sort_keys=True))
    return sorted(out)


@pytest.mark.parametrize("client, wire", [("jax", "v1"), ("jax", "v2"), ("port", "v2")])
def test_cross_package_replay(client, wire, tmp_path, monkeypatch):
    """A JAX daemon and the port daemon (``device='cpu'``) each serve the
    same stream, replayed over loopback by ``client``'s ``run_loadgen``:
    the verdict records are equal but for ``ts`` and ``lat_ms``, every row
    is covered, and both daemons quarantine the 5 corrupted rows."""
    monkeypatch.chdir(tmp_path)
    stream = planted_prototypes(12, concepts=3, rows_per_concept=220, features=6)
    loadgen = jloadgen if client == "jax" else tloadgen
    kw = dict(partitions=P, per_batch=B, model="centroid", results_csv="", seed=12,
              window=1, data_policy="quarantine")
    # linger long enough that no seal splits the replay (the loadgen ends it
    # with FLUSH), so both daemons seal the same chunks
    pkw = dict(num_features=6, num_classes=stream.num_classes, port=0, chunk_batches=CB,
               linger_s=5.0)
    recs, spans = {}, {}
    for name, runner in (
        ("jax", JServeRunner(JRunConfig(**kw, telemetry_dir=str(tmp_path / "j")),
                             JServeParams(**pkw))),
        ("port", ServeRunner(RunConfig(**kw, telemetry_dir=str(tmp_path / "t")),
                             ServeParams(**pkw), device="cpu")),
    ):
        banner, t = _serve(runner)
        X, y = stream.X.copy(), stream.y.copy()
        if wire == "v2":
            loadgen.apply_dirty_frames(X, y, "nan_cell:5:7")
            lines, arrays = None, (X, y)
        else:
            lines, arrays = loadgen.format_lines(X, y), None
            loadgen.apply_dirty(lines, "nan_cell:5:7")
        # v1 replays head-sample rows with TRACE stamps: the verdicts list
        # the chunk's trace ids and the run log holds each row's span chain
        rep = loadgen.run_loadgen(banner["host"], banner["port"], lines, verdicts=banner["verdicts"],
                                  timeout=120, stop=True, wire_version=wire, arrays=arrays,
                                  trace_sample=0.25 if wire == "v1" else 0.0, trace_seed=3)
        t.join(timeout=120)
        assert not t.is_alive()
        assert rep["rows_covered"] == stream.num_rows and not rep["timeout"]
        assert runner.admission.rows_quarantined == 5
        recs[name] = _records(banner["verdicts"])
        spans[name] = _spans(banner["run_log"])
    assert recs["port"] == recs["jax"]
    assert sum(r["detections"] for r in recs["port"]) > 0
    assert spans["port"] == spans["jax"]
    if wire == "v1":
        assert sum(len(r.get("traces", ())) for r in recs["port"]) > 0
        assert len({json.loads(e)["name"] for e in spans["port"]}) >= 4
