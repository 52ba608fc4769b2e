"""The port's parity tools (``utils/parity.py``, ``utils/parity_suite.py``)
against the JAX package's, on the CPU.

``output_snr`` and ``parity_report`` give the JAX package's numbers exactly.
The kit runner is held end to end: a GTCRN kit whose checkpoint is
``tests/test_importers.py``'s synthetic upstream state dict and whose ref is
the JAX package's ``Session`` output on the artifact that the JAX
``export_artifact`` made from it; the port exports the same checkpoint
through its own importer and serves it through its own ``Session``, and
must clear the 40 dB gate.  Then the cases of the JAX package's
``tests/test_parity_suite.py``: a missing ref reported as the JAX package
reports it, a noise ref failing, a threshold override, the case grouping and
the kit errors.
"""
import json

import numpy as np
import pytest
import torch

from audiojax.utils import parity as jparity
from audiojax.utils import parity_suite as jsuite
from test_importers import _gtcrn_state_dict
from test_torch_ckpt_builders import one_thread  # noqa: F401
from torch_isolation import hide_module_stubs  # noqa: F401

from audiojax_torch import utils as port_utils
from audiojax_torch.runtime.audio_io import write_wav
from audiojax_torch.utils import parity, parity_suite


def test_output_snr_matches_jax():
    rng = np.random.default_rng(5)
    ref = (rng.standard_normal(4000) * 3000).astype(np.int16)
    noisy = (ref + rng.standard_normal(4000) * 30).astype(np.int16)
    cases = [(ref, noisy), (ref, ref.copy()), (ref, noisy[:2500]), (ref[:1000], noisy),
             (ref.astype(np.float32), noisy.astype(np.float64)),
             (np.zeros(100, np.int16), noisy[:100])]
    for a, b in cases:
        want = jparity.output_snr(a, b)
        assert parity.output_snr(a, b) == want
        assert parity.parity_report(a, b) == jparity.parity_report(a, b)
        assert (parity.parity_report(a, b, threshold_db=80.0)
                == jparity.parity_report(a, b, threshold_db=80.0))
    assert parity.output_snr(ref, ref.copy()) == float("inf")
    assert parity.parity_report(ref, ref.copy())["passed"] is True
    assert port_utils.output_snr is parity.output_snr
    assert port_utils.parity_report is parity.parity_report
    assert port_utils.__all__ == ["measure_rtf", "output_snr", "parity_report"]


def _build_kit(tmp_path, seed=0):
    kit = tmp_path / "kit"
    mdir = kit / "gtcrn"
    (mdir / "inputs").mkdir(parents=True)
    (mdir / "ref").mkdir()
    torch.manual_seed(seed)
    sd = _gtcrn_state_dict()
    torch.save(sd, mdir / "checkpoint.pt")
    rng = np.random.default_rng(seed)
    noisy = (rng.standard_normal(16000) * 5000).astype(np.int16)
    write_wav(mdir / "inputs" / "case0.wav", noisy, 16000)
    return kit, mdir, sd, noisy


def _jax_output(sd, noisy, workdir):
    """The JAX package's answer: its export of the checkpoint, its Session."""
    from audiojax.runtime import Session, load_artifact, registry
    from audiojax.runtime.export import export_artifact
    from audiojax.runtime.optimize import wrap_forward

    export_artifact("gtcrn", sd, workdir, smoke=False)
    params, manifest = load_artifact(workdir)
    spec = registry.get("gtcrn")
    return Session(wrap_forward(spec.make_forward(spec.make_config()), manifest),
                   params, manifest).process(noisy[None]).audio


def test_parity_suite_port_against_jax_ref(tmp_path, capsys):
    kit, mdir, sd, noisy = _build_kit(tmp_path)

    # no ref yet: reported as the JAX package reports it, with no case served
    want = jsuite.run_model_dir("gtcrn", mdir, workdir=tmp_path / "j0")
    got = parity_suite.run_model_dir("gtcrn", mdir, workdir=tmp_path / "w0", device="cpu")
    assert got == want
    assert got["cases"] == [{"case": "case0", "error": "missing case0.wav under ref/"}]

    ref = _jax_output(sd, noisy, tmp_path / "jart")
    write_wav(mdir / "ref" / "case0.wav", ref, 16000)
    report = parity_suite.run_kit(kit, workdir=tmp_path / "w1", device="cpu")
    assert report["passed"] is True and report["kit"] == str(kit)
    (m,) = report["models"]
    assert m["model"] == "gtcrn" and m["threshold_db"] == 40.0
    assert m["cases"][0]["snr_db"] >= 40.0 and m["min_snr_db"] == m["cases"][0]["snr_db"]

    # parity's CLI on the port's artifact of the kit and the same JAX ref
    assert parity.main(["--model", "gtcrn", "--artifact", str(tmp_path / "w1" / "gtcrn"),
                        "--input", str(mdir / "inputs" / "case0.wav"),
                        "--reference", str(mdir / "ref" / "case0.wav"), "--device", "cpu"]) == 0
    cli = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli["passed"] is True and cli["snr_db"] == pytest.approx(m["cases"][0]["snr_db"],
                                                                    abs=0.01)
    print(f"\nport vs JAX on the kit: {m['cases'][0]['snr_db']} dB")

    # a noise ref fails the 40 dB gate; a -100 dB threshold passes it
    noise = (np.random.default_rng(9).standard_normal(16000) * 5000).astype(np.int16)
    write_wav(mdir / "ref" / "case0.wav", noise, 16000)
    assert parity_suite.run_kit(kit, workdir=tmp_path / "w2", device="cpu")["passed"] is False
    (mdir / "config.json").write_text(json.dumps({"threshold_db": -100.0}))
    report = parity_suite.run_kit(kit, workdir=tmp_path / "w3", device="cpu")
    assert report["passed"] is True and report["models"][0]["threshold_db"] == -100.0


def test_parity_suite_case_grouping_and_errors(tmp_path):
    d = tmp_path / "inputs"
    d.mkdir()
    for n in ("a.wav", "b.0.wav", "b.1.wav", "c.2.wav", "notes.txt"):
        (d / n).write_bytes(b"")
    cases = parity_suite._cases(d)
    assert cases == jsuite._cases(d)
    assert sorted(cases) == ["a", "b", "c"]
    assert [p.name for p in cases["b"]] == ["b.0.wav", "b.1.wav"]

    (tmp_path / "kit" / "not_a_model").mkdir(parents=True)
    with pytest.raises(SystemExit, match="not registry models"):
        parity_suite.run_kit(tmp_path / "kit", device="cpu")
    with pytest.raises(SystemExit, match=r"models not in kit: \['gtcrn'\]"):
        parity_suite.run_kit(tmp_path / "kit", models=["gtcrn"], device="cpu")
    (tmp_path / "kit" / "not_a_model").rmdir()
    with pytest.raises(SystemExit, match="no model directories"):
        parity_suite.run_kit(tmp_path / "kit", device="cpu")
    (tmp_path / "kit" / "gtcrn").mkdir()
    want = jsuite.run_model_dir("gtcrn", tmp_path / "kit" / "gtcrn", workdir=tmp_path)
    got = parity_suite.run_model_dir("gtcrn", tmp_path / "kit" / "gtcrn", workdir=tmp_path,
                                     device="cpu")
    assert got == want == {"model": "gtcrn", "error": "no checkpoint.{pt,tar,pth,npz} in kit"}
