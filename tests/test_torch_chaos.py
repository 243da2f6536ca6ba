"""The chaos scenarios of ``scripts/chaos_run_torch.py`` on a CPU
``LocalMesh`` of 8 slots: the twins of ``tests/test_chaos.py``.

The reference runs each scenario in a subprocess with 8 forced host
devices; the port's local mesh holds the 8 slots in this process, so each
test calls the scenario function in process and then re-checks the
recovery-event artifact it wrote, as the reference's tests do.  The heavy
assertions (bit-identical resume, honest R8 degrade, the ``recover.*``
spans in the obs trace) live in the script itself."""
import importlib.util
import json
import os
import sys

from repro_torch import obs

from conftest import REPO

_spec = importlib.util.spec_from_file_location(
    "chaos_run_torch", os.path.join(REPO, "scripts", "chaos_run_torch.py"))
chaos = importlib.util.module_from_spec(_spec)
sys.modules["chaos_run_torch"] = chaos        # its dataclass looks it up
_spec.loader.exec_module(chaos)


def _run(scenario, tmp_path):
    out = tmp_path / "events.json"
    chaos.run(scenario, str(out), device="cpu")
    doc = json.loads(out.read_text())
    assert doc["scenario"] == scenario and doc["devices"] == 8
    assert doc["device"] == "cpu"
    return doc


def test_chaos_kill_at_batch(tmp_path):
    doc = _run("kill-at-batch", tmp_path)
    # Leg A: one kill, mesh rebuilt on the 7 survivors, still sharded.
    (a,) = doc["legA"]
    assert a["kind"] == "device_lost" and a["survivors"] == 7
    assert a["backend_before"] == a["backend_after"] == "shard_map"
    # Leg B: cascade kills down to 4 survivors force the honest
    # single-host degrade, and the R8 explanation travels in the event.
    kinds = [e["kind"] for e in doc["legB"]]
    assert kinds == ["device_lost"] * 4
    assert doc["legB"][0]["backend_after"] == "single"
    assert doc["legB"][-1]["survivors"] == 4
    assert any("degrading honestly" in r
               for e in doc["legB"] for r in e["reasons"])
    assert doc["legB_rel_err"] <= 1e-5
    assert all(e["r8_peak_bytes"] > 0 for e in doc["legA"] + doc["legB"])


def test_chaos_persistent_straggler(tmp_path):
    doc = _run("persistent-straggler", tmp_path)
    (ev,) = doc["events"]
    assert ev["kind"] == "straggler_evict"
    assert ev["device"] == 1 and ev["survivors"] == 7
    assert doc["backup_saved_s"] > 0
    # The supervisor's metrics, as the scenario's obs run left them: three
    # flags (patience 3), the first two shadowed, then the eviction.
    text = obs.export_text()
    for line in ('straggler_flagged_total 3', 'straggler_backup_total 2',
                 'straggler_evictions_total 1',
                 'recovery_events_total{kind="straggler_evict"} 1',
                 'planner_plans_total{rule="R8"} 1',
                 'stream_healthy_devices 7'):
        assert line in text.splitlines(), line
    obs.reset()


def test_chaos_kill_during_merge(tmp_path):
    doc = _run("kill-during-merge", tmp_path)
    kinds = [e["kind"] for e in doc["events"]]
    assert kinds == ["collective_retry", "device_lost"]
    retry = doc["events"][0]
    assert retry["retries"] == 1
    assert retry["resumed_from_batch"] == 2   # last commit before batch 3
