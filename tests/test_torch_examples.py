"""The port's four continual-learning examples (`repro_torch.examples`:
`quickstart`, `continual_cv`, `fleet`, `multi_stream`), each the
counterpart of the reference's script of the same name, run through their
`main` with `--device cpu` at small sizes.

- The quickstart holds the verify recipe's sanity check: ETuner shows
  lower time and energy than Immediate, nonzero freezes and two or more
  recompiles.
- `continual_cv` prints one row a paper method, normalized to Immed.
- `fleet` runs a 2-device least-loaded fleet with a trace whose device
  spans `trace_report` summarizes.
- `multi_stream` runs the verify recipe's QoS check: under the
  priority-weighted trigger the priority-2 stream runs fewer rounds and a
  lower p95 than the bulk stream.
"""
import functools
import io
import json
import warnings
from contextlib import redirect_stdout
from unittest import mock

import pytest
import torch

from repro_torch.examples import continual_cv, fleet, multi_stream, quickstart
from repro_torch.harness import trace_report


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: a test worker shares the machine's cores with
    the others, and torch's OpenMP threads would spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@functools.lru_cache(maxsize=None)
def _quickstart():
    """The quickstart's results and printed lines."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        results = quickstart.main(["--device", "cpu"])
    return results, buf.getvalue().splitlines()


def test_quickstart_passes_its_sanity_check():
    results, out = _quickstart()
    assert quickstart.sanity(results) == []
    (imm, _), (et, et_rt) = results["Immediate"], results["ETuner"]
    assert et.total_time_s < imm.total_time_s
    assert et_rt.controller.stats()["freezes"] > 0 and et.recompiles >= 2
    assert [line.split()[0] for line in out[::3]] == ["Immediate", "ETuner"]
    assert all(line.strip().startswith("breakdown:") for line in out[1::3])


def test_quickstart_sanity_names_what_failed():
    results, _ = _quickstart()
    swapped = {"Immediate": results["ETuner"],
               "ETuner": results["Immediate"]}
    failed = quickstart.sanity(swapped)
    assert "ETuner's time is not below Immediate's" in failed
    assert "ETuner froze nothing" in failed


def test_continual_cv_prints_a_row_a_method(capsys):
    rows = continual_cv.main(["--scenarios", "2", "--batches", "4",
                              "--inferences", "10", "--device", "cpu"])
    assert [r["method"] for r in rows] == ["immed", "lazytune", "simfreeze",
                                           "etuner"]
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and out[0].startswith("immed ")
    assert "(100.0%)" in out[0] and "tflops=" in out[-1]
    assert all(r["rounds"] >= 1 and 0 <= r["acc"] <= 1 for r in rows)


def test_fleet_runs_and_traces(tmp_path, capsys):
    trace = tmp_path / "fleet.json"
    cell = fleet.main(["--devices", "2", "--streams", "4", "--batches", "2",
                       "--inferences", "4", "--scenarios", "2",
                       "--aggregate-every", "50", "--device", "cpu",
                       "--trace-out", str(trace)])
    assert cell["devices"] == 2 and cell["streams"] == 4
    out = capsys.readouterr().out
    assert "device dev0" in out and "device dev1" in out
    assert json.loads(trace.read_text())["traceEvents"]
    assert trace_report.main([str(trace), "--validate"]) == 0


def test_multi_stream_priority_weighted_qos(capsys):
    cell = multi_stream.main(["--preset", "qos", "--preemptible",
                              "--trigger-policy", "priority-weighted",
                              "--batches", "4", "--inferences", "10",
                              "--scenarios", "2", "--device", "cpu"])
    assert cell["preemptible"] == 1
    assert cell["trigger_policy"] == "priority-weighted"
    per = cell["per_stream"]
    prio = {sid: multi_stream.presets(
        batches_per_scenario=4, inferences=10, num_scenarios=2,
        seed=0)["qos"].streams[int(sid)].priority for sid in per}
    hi, lo = max(prio, key=prio.get), min(prio, key=prio.get)
    assert prio[hi] == 2
    assert per[hi]["rounds"] < per[lo]["rounds"]
    assert per[hi]["latency_p95"] < per[lo]["latency_p95"]
    out = capsys.readouterr().out
    assert out.startswith("workload qos: 2 stream(s)")
    assert "stream 0 [" in out and "model  default" in out


def test_examples_run_on_the_card_unless_told(monkeypatch):
    """Without `--device` each example asks for CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (quickstart, continual_cv, fleet, multi_stream):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])
    with mock.patch.object(quickstart, "edgeol_session") as session:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quickstart.main([])
        session.assert_not_called()
