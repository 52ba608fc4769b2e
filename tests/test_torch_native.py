"""The port's native bridge, FLAC input and the Session's native routes
against the JAX package, on the CPU.

Both packages build ``native/audioio.cc`` (the port into
``audiojax_torch/_build/``, the JAX package beside the source), so every
native function of the port must equal the JAX package's bit for bit on the
same inputs.  FLAC streams come from ``tests/flac_golden.py``, an encoder
written from the format's specification, so a decode is held bit-exact.
``read_audio`` dispatches by magic bytes; the ffmpeg hook is a stub script
(no ffmpeg here).  The port's ``Session`` slices and stitches in numpy
(the bridge's slicing is slower, its stitch no faster); the bridge's route,
which the JAX ``Session`` takes, must give its answer (stitch within 1 LSB,
as ``tests/test_native.py`` allows), and a FLAC request serves as the JAX
``Session`` serves it.
"""
import stat

import numpy as np
import pytest
import torch
from torch import nn

import jax

from audiojax.runtime import native as jnative
from audiojax.runtime import registry as jregistry
from audiojax.runtime.audio_io import read_wav as jread_wav
from audiojax.runtime.session import Session as JSession
from flac_golden import encode_flac
from reference_loader import snr_db
from test_torch_ckpt_builders import one_thread  # noqa: F401

from audiojax_torch.params import params_from_numpy
from audiojax_torch.runtime import audio_io, native
from audiojax_torch.runtime import registry as tregistry
from audiojax_torch.runtime.manifest import Manifest
from audiojax_torch.runtime.session import Session

pytestmark = pytest.mark.skipif(not (native.available() and jnative.available()),
                                reason="g++ toolchain unavailable")


def _speechish(n, channels=1, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    sig = 0.4 * np.sin(2 * np.pi * 310 * t) + 0.1 * np.sin(2 * np.pi * 997 * t)
    out = np.stack([sig * (1 - 0.2 * c) + 0.05 * rng.standard_normal(n) for c in range(channels)])
    return (out * 14000).astype(np.int16)


def test_bridge_builds_into_the_package():
    """The port's library lies in its own ``_build``, never beside the source."""
    so = native.library_path()
    assert native.build_error() is None
    assert so.exists() and so.parent.name == "_build" and so.parent.parent.name == "audiojax_torch"
    assert so.parent != native.SOURCE.parent


def test_build_failure_is_recorded(tmp_path, monkeypatch):
    """A source g++ refuses leaves the bridge absent, with the compiler's
    message in ``build_error()`` and in the error of a call."""
    bad = tmp_path / "audioio.cc"
    bad.write_text("this is not C++\n")
    for name, value in (("SOURCE", bad), ("BUILD_DIR", tmp_path / "_build"), ("_lib", None),
                        ("_tried", False), ("_error", None)):
        monkeypatch.setattr(native, name, value)
    assert not native.available()
    assert "g++ failed" in native.build_error() and "error" in native.build_error()
    with pytest.raises(RuntimeError, match="native audioio unavailable: RuntimeError: g\\+\\+"):
        native.slice_windows(np.zeros(8, np.int16), 4, 4, 0, 2)
    assert not list((tmp_path / "_build").glob("*.so*"))  # no half-built library left


def _case(name, tmp_path):
    """(port result, JAX result) of one native function on the same inputs."""
    rng = np.random.default_rng(abs(hash(name)) % 1000)
    if name == "read_wav_mono16":
        p = audio_io.write_wav(tmp_path / "x.wav", (rng.standard_normal((2, 4000)) * 9000)
                               .astype(np.int16), 16000)
        return native.read_wav_mono16(p), jnative.read_wav_mono16(p)
    if name == "slice_windows":
        audio = (rng.standard_normal(10_500) * 8000).astype(np.int16)
        args = (audio, 4000, 3000, 500, 4)
        return native.slice_windows(*args), jnative.slice_windows(*args)
    if name == "encode_wav_pcm16":
        audio = (rng.standard_normal((2, 3000)) * 9000).astype(np.int16)
        return native.encode_wav_pcm16(audio, 44100), jnative.encode_wav_pcm16(audio, 44100)
    if name == "resample_linear":
        audio = (rng.standard_normal((3, 1601)) * 12000).astype(np.int16)
        return ([native.resample_linear(audio, n) for n in (534, 4803, 581)],
                [jnative.resample_linear(audio, n) for n in (534, 4803, 581)])
    if name == "normalise_rms":
        audio = (rng.standard_normal(5000) * 300).astype(np.int16)
        return native.normalise_rms(audio, 4096.0), jnative.normalise_rms(audio, 4096.0)
    if name == "ola_stitch":
        wins = (rng.standard_normal((4, 1000)) * 9000).astype(np.int16)
        return native.ola_stitch(wins, 700), jnative.ola_stitch(wins, 700)
    if name == "decode_flac":
        blob = encode_flac(_speechish(5000, channels=2, seed=3), 16000, stereo="mid_side")
        return native.decode_flac(blob), jnative.decode_flac(blob)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["read_wav_mono16", "slice_windows", "encode_wav_pcm16",
                                  "resample_linear", "normalise_rms", "ola_stitch", "decode_flac"])
def test_native_function_equals_jax(name, tmp_path):
    ours, ref = _case(name, tmp_path)
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        if isinstance(a, bytes):
            assert a == b
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)


def test_wav_bound_checks(tmp_path):
    """A header that claims more frames than the file holds, and a bit depth
    under 8, are refused before the C decode runs."""
    import struct

    def header(bits, n_bytes):
        fmt = struct.pack("<4sIHHIIHH", b"fmt ", 16, 1, 1, 16000, 16000 * 2, 2, bits)
        return b"RIFF" + struct.pack("<I", 36 + n_bytes) + b"WAVE" + fmt + \
            b"data" + struct.pack("<I", n_bytes)

    p = tmp_path / "t.wav"
    p.write_bytes(header(16, 100_000) + b"\x00" * 64)
    with pytest.raises(ValueError, match="truncated WAV"):
        native.read_wav_mono16(p)
    p.write_bytes(header(4, 64) + b"\x00" * 64)
    with pytest.raises(ValueError, match="bit depth|invalid WAV"):
        native.read_wav_mono16(p)
    p.write_bytes(b"this is not a wav file at all, sorry")
    with pytest.raises(ValueError, match="invalid WAV"):
        native.read_wav_mono16(p)


@pytest.mark.parametrize("kw", [
    dict(subframe="verbatim", order=0), dict(subframe="fixed", order=0),
    dict(subframe="fixed", order=2), dict(subframe="fixed", order=4),
    dict(subframe="lpc", lpc=([2045, -1023], 12, 10)), dict(stereo="independent"),
    dict(stereo="left_side"), dict(stereo="mid_side"),
], ids=lambda kw: "-".join(str(v) for v in kw.values())[:24])
def test_flac_golden_decodes_bit_exact(kw):
    channels = 2 if "stereo" in kw else 1
    pcm = _speechish(4096, channels=channels, seed=len(kw))
    out, rate = native.decode_flac(encode_flac(pcm, 44100, **kw))
    assert rate == 44100
    np.testing.assert_array_equal(out, pcm)


def test_flac_constant_and_wasted_bits_and_unknown_length():
    """A constant subframe, wasted low bits, and a long run of silence whose
    stream does not state its length (far smaller than its samples: the
    output buffer must grow, never cut the decode)."""
    pcm = np.full((1, 3072), -1234, np.int16)
    np.testing.assert_array_equal(native.decode_flac(encode_flac(pcm, 48000,
                                                                 subframe="constant"))[0], pcm)
    pcm = _speechish(2048, seed=5) & ~np.int16(7)
    np.testing.assert_array_equal(native.decode_flac(encode_flac(
        pcm, 16000, subframe="fixed", order=1, wasted=3))[0], pcm)
    silence = np.zeros((1, 200_000), np.int16)
    blob = bytearray(encode_flac(silence, 16000, subframe="constant", blocksize=4096))
    # STREAMINFO's 36-bit total (bits 108–143 of the block after the 8-byte
    # prefix) set to 0: unknown, so the decoder's buffer starts small and grows
    blob[8 + 13] &= 0xF0
    blob[8 + 14: 8 + 18] = bytes(4)
    out, _ = native.decode_flac(bytes(blob))
    np.testing.assert_array_equal(out, silence)


def test_flac_fails_closed_on_corruption():
    blob = bytearray(encode_flac(_speechish(2048), 16000))
    blob[len(blob) // 2] ^= 0x40  # a bit flipped mid-frame: the CRC-16 fails
    with pytest.raises(ValueError):
        native.decode_flac(bytes(blob))


def test_read_audio_dispatches_by_magic(tmp_path, monkeypatch):
    monkeypatch.setenv("AUDIOJAX_FFMPEG", "")  # nothing may reach a stray ffmpeg
    pcm = _speechish(3000, channels=2, seed=9)
    (tmp_path / "x.flac").write_bytes(encode_flac(pcm, 16000, stereo="mid_side"))
    wav = audio_io.write_wav(tmp_path / "x.wav", pcm, 16000)
    for p in (tmp_path / "x.flac", wav):
        out, rate = audio_io.read_audio(p)
        assert rate == 16000
        np.testing.assert_array_equal(out, pcm)
    np.testing.assert_array_equal(jread_wav(wav)[0], pcm)  # the native RIFF reads in both
    (tmp_path / "x.bin").write_bytes(b"\x00\x01\x02\x03junk")
    with pytest.raises(ValueError, match="unrecognised container.*register_decoder"):
        audio_io.read_audio(tmp_path / "x.bin")

    # a registered decoder takes its magic before the built-in ones
    seen = []
    monkeypatch.setattr(audio_io, "_DECODERS", list(audio_io._DECODERS))
    audio_io.register_decoder(b"\x00\x01", lambda p: (seen.append(p), (pcm[:1], 8000))[1])
    assert audio_io.read_audio(tmp_path / "x.bin")[1] == 8000 and seen
    with pytest.raises(ValueError, match="32-byte"):
        audio_io.register_decoder(b"x" * 33, lambda p: None)


def test_read_audio_names_the_format_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setenv("AUDIOJAX_FFMPEG", "")
    for name, head, kind in (("x.mp3", b"ID3\x04\x00", "MP3 input .*ffmpeg"),
                             ("y.mp3", b"\xff\xfb\x90\x00", "MP3 input"),
                             ("z.ogg", b"OggS", "OGG"), ("a.m4a", b"\x00\x00\x00\x20ftypM4A ",
                                                         "MP4/M4A")):
        (tmp_path / name).write_bytes(head + b"\x00" * 64)
        with pytest.raises(ValueError, match=kind):
            audio_io.read_audio(tmp_path / name)


def test_read_audio_ffmpeg_hook(tmp_path, monkeypatch):
    """``$AUDIOJAX_FFMPEG`` names a converter (a stub here, which copies a
    WAV made beforehand to the last argument, ffmpeg's output); a failing
    converter's message reaches the error."""
    pcm = _speechish(3000, seed=11)
    golden = audio_io.write_wav(tmp_path / "golden.wav", pcm, 16000)
    ok = tmp_path / "ffmpeg_ok.sh"
    ok.write_text(f'#!/bin/sh\nfor a; do out=$a; done\ncp {golden} "$out"\n')
    bad = tmp_path / "ffmpeg_bad.sh"
    bad.write_text("#!/bin/sh\necho 'boom: bad stream' >&2\nexit 1\n")
    for stub in (ok, bad):
        stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    (tmp_path / "x.mp3").write_bytes(b"ID3\x04\x00" + b"\x00" * 64)
    monkeypatch.setenv("AUDIOJAX_FFMPEG", str(ok))
    out, rate = audio_io.read_audio(tmp_path / "x.mp3")
    assert rate == 16000
    np.testing.assert_array_equal(out, pcm)
    monkeypatch.setenv("AUDIOJAX_FFMPEG", str(bad))
    with pytest.raises(ValueError, match="ffmpeg failed .*boom"):
        audio_io.read_audio(tmp_path / "x.mp3")


def test_audio_io_native_routes_equal_numpy(monkeypatch):
    """``resample_np`` and ``normalise_rms`` on int16 take the bridge; their
    numpy routes give the same (the RMS within 1 LSB: another summation order)."""
    rng = np.random.default_rng(4)
    audio = (rng.standard_normal((2, 4801)) * 9000).astype(np.int16)
    nat = (audio_io.resample_np(audio, 48000, 16000), audio_io.normalise_rms(audio[0] // 20))
    monkeypatch.setattr(native, "available", lambda: False)
    ref = (audio_io.resample_np(audio, 48000, 16000), audio_io.normalise_rms(audio[0] // 20))
    np.testing.assert_array_equal(nat[0], ref[0])
    assert np.abs(nat[1].astype(np.int32) - ref[1].astype(np.int32)).max() <= 1


class _Triple(nn.Module):
    """A stand-in model: each window's samples repeated three times and halved
    (int16 in, int16 out, 3× the samples, as MossFormer2-SR's output)."""

    def forward(self, x):
        return torch.repeat_interleave(x // 2, 3, dim=-1)


def _overlapped_manifest() -> Manifest:
    return Manifest(model_name="triple", task="super_resolution", model_family="toy",
                    in_sample_rate=16000, out_sample_rate=48000, model_sample_rate=48000,
                    input_audio_length=8000,
                    overlap_length=2000, input_to_output_scale=3.0)


def test_session_native_route_equals_numpy(monkeypatch):
    """Overlapped windows (SR's geometry, 3× out): ``Session`` slices and
    stitches in numpy whether the bridge is built or not, and the bridge's
    route (the JAX ``Session``'s: ``slice_windows``, the model,
    ``ola_stitch``) gives its answer within 1 LSB."""
    clip = _speechish(37_000, seed=12)[0]
    session = Session(_Triple(), _overlapped_manifest(), device="cpu")
    out = session.process(clip)
    w, stride, num, num_padded = session._window_geometry(clip.size)
    with torch.inference_mode():
        wins = _Triple()(torch.from_numpy(native.slice_windows(clip, w, stride, 0, num_padded)))
    bridged = native.ola_stitch(wins[:num].numpy(), 3 * stride)[: 3 * clip.size]
    monkeypatch.setattr(native, "available", lambda: False)
    ref = Session(_Triple(), _overlapped_manifest(), device="cpu").process(clip)
    np.testing.assert_array_equal(out.audio, ref.audio)
    assert out.audio.shape == bridged.shape == (3 * clip.size,)
    assert np.abs(out.audio.astype(np.int32) - bridged.astype(np.int32)).max() <= 1


def test_session_serves_a_flac_request_as_jax(tmp_path):
    """GTCRN at its default width: a 2.5 s request written as FLAC, decoded
    by the bridge through ``read_audio`` and served by the port's ``Session``,
    equals the same request read from WAV, and the JAX ``Session``'s answer
    on the same parameters at the family's 40 dB gate."""
    pcm = _speechish(40_000, seed=13)
    (tmp_path / "r.flac").write_bytes(encode_flac(pcm, 16000))
    wav = audio_io.write_wav(tmp_path / "r.wav", pcm, 16000)
    flac, rate = audio_io.read_audio(tmp_path / "r.flac")
    assert rate == 16000
    np.testing.assert_array_equal(flac, audio_io.read_audio(wav)[0])

    jspec, tspec = jregistry.get("gtcrn"), tregistry.get("gtcrn")
    jcfg, tcfg = jspec.make_config(), tspec.make_config()
    pj = jax.jit(jspec.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    session = Session(tspec.make_module(pt, tcfg), tspec.make_manifest(tcfg), device="cpu")
    out = session.process(flac[0])
    ref = JSession(jspec.make_forward(jcfg), pj, jspec.make_manifest(jcfg)).process(flac[0])
    assert out.audio.shape == ref.audio.shape == (pcm.shape[-1],)
    assert snr_db(ref.audio, out.audio) >= 40.0
