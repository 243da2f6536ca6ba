"""The port's example scripts (``examples/*_torch.py``) on the CPU.

Each twin's ``main(device="cpu")`` runs to its end and passes its own
checks (against numpy, bit-identical resumes and windows, the float32
prefill check), with observability on where the script has ``--observe``.
On the card ``chip_smoke.py`` runs them as scripts (phase ``examples``).
"""
import importlib.util
import os

import pytest

from repro_torch import obs

from conftest import REPO
from test_torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _load(name):
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def clean_obs():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


CASES = [
    ("quickstart_torch", {}),
    ("streaming_svd_torch", {"observe": False}),
    ("streaming_svd_torch", {"observe": True}),
    ("serving_topk_torch", {"observe": False}),
    ("serving_topk_torch", {"observe": True}),
    ("serve_lm_torch", {}),
    ("distributed_svd_torch", {}),
    ("distributed_streaming_torch", {}),
    ("elastic_ingest_torch", {}),
    # the trainers at a few steps (short sequences, the embedding of
    # GaLore's run cut so that its m-side gram is small on the CPU)
    ("train_lm_torch", {"steps": 3, "seq": 32, "batch": 2}),
    ("gradient_compression_torch", {"steps": 3, "vocab": 1024, "seq": 32}),
]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}{'-observe' if kw.get('observe') else ''}"
                              for n, kw in CASES])
def test_example_runs_and_passes_its_checks(clean_obs, capsys, name, kw):
    out = _load(name).main(device="cpu", **kw)
    printed = capsys.readouterr().out
    # on the CPU every kernel wrapper takes its plain version
    assert set(out["launches"].values()) == {0}
    if kw.get("observe"):
        assert obs.enabled() and "observability (--observe)" in printed
    assert "Traceback" not in printed


def test_serve_lm_twin_serves_moe_and_refuses_frameless_whisper(clean_obs):
    """The LM twin serves qwen3-moe's smoke config (its float32 prefill
    check at the no-drop capacity factor); whisper-small's text requests
    carry no encoder frames and raise, as the reference's example stops
    at its assert."""
    twin = _load("serve_lm_torch")
    out = twin.main(arch="qwen3-moe-235b-a22b", tokens=4, device="cpu")
    assert set(out["launches"].values()) == {0}
    assert max(out["prefill_rel_err"].values()) <= twin.PREFILL_REL
    with pytest.raises(ValueError, match="frames"):
        twin.main(arch="whisper-small", device="cpu")
