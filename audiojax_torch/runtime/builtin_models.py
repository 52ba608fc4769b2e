"""Built-in model registrations (grows as model families are ported)."""
from __future__ import annotations

from functools import partial

from .manifest import Manifest
from .registry import ModelSpec, register


def _gtcrn_manifest(cfg):
    return Manifest(
        model_name="gtcrn",
        task="denoise",
        model_family="GTCRN",
        in_sample_rate=cfg.in_sample_rate,
        out_sample_rate=cfg.out_sample_rate,
        model_sample_rate=cfg.sample_rate,
        input_audio_length=32000 * cfg.in_sample_rate // 16000,
        window_type=cfg.window,
        nfft=cfg.n_fft,
        window_length=cfg.n_fft,
        hop_length=cfg.hop,
        pad_mode=cfg.pad_mode,
        center_pad=True,
        fold_window_length=cfg.fold_window,
        batch_fold_inference_default=bool(cfg.fold_window),
        batch_window_seconds=1.5 if cfg.fold_window else 0.0,
    )


def _mossformergan_manifest(cfg):
    return Manifest(
        model_name="mossformergan_se",
        task="denoise",
        model_family="mossformer_gan_se",
        in_sample_rate=cfg.in_sample_rate,
        out_sample_rate=cfg.out_sample_rate,
        model_sample_rate=cfg.sample_rate,
        input_audio_length=96000 * cfg.in_sample_rate // 16000,
        window_type=cfg.window,
        nfft=cfg.n_fft,
        window_length=cfg.n_fft,
        hop_length=cfg.hop,
        pad_mode=cfg.pad_mode,
        center_pad=True,
        fold_window_length=cfg.fold_window,
        batch_fold_inference_default=bool(cfg.fold_window),
        batch_window_seconds=1.5 if cfg.fold_window else 0.0,
        extra={"compress_factor": cfg.compress, "emb_dim": cfg.emb_dim},
    )


def _register_mossformergan():
    from ..models.mossformergan_se import MossFormerGAN, MossFormerGanConfig, init_mossformergan

    register(
        ModelSpec(
            name="mossformergan_se",
            task="denoise",
            make_config=MossFormerGanConfig,
            init_params=init_mossformergan,
            make_module=MossFormerGAN,
            make_manifest=_mossformergan_manifest,
        )
    )


def _zipenhancer_manifest(cfg):
    return Manifest(
        model_name="zipenhancer",
        task="denoise",
        model_family="zipenhancer",
        in_sample_rate=cfg.in_sample_rate,
        out_sample_rate=cfg.out_sample_rate,
        model_sample_rate=cfg.sample_rate,
        input_audio_length=96000 * cfg.in_sample_rate // 16000,
        window_type=cfg.window,
        nfft=cfg.n_fft,
        window_length=cfg.n_fft,
        hop_length=cfg.hop,
        pad_mode=cfg.pad_mode,
        center_pad=True,
        fold_window_length=cfg.fold_window,
        batch_fold_inference_default=bool(cfg.fold_window),
        batch_window_seconds=1.5 if cfg.fold_window else 0.0,
        normalize_audio_default=True,
        extra={"compress_factor": cfg.compress, "channels": cfg.channels},
    )


def _register_zipenhancer():
    from ..models.zipenhancer import ZipEnhancer, ZipEnhancerConfig, init_zipenhancer

    register(
        ModelSpec(
            name="zipenhancer",
            task="denoise",
            make_config=ZipEnhancerConfig,
            init_params=init_zipenhancer,
            make_module=ZipEnhancer,
            make_manifest=_zipenhancer_manifest,
        )
    )


def _mossformer2_ss_manifest(cfg):
    return Manifest(
        model_name="mossformer2_ss",
        task="separation",
        model_family="mossformer2_ss",
        in_sample_rate=cfg.in_sample_rate,
        out_sample_rate=cfg.out_sample_rate,
        model_sample_rate=cfg.sample_rate,
        input_audio_length=32000 * cfg.in_sample_rate // 16000,
        max_dynamic_audio_seconds=6,
        output_sources=cfg.num_spks,
        pad_head=8000,
        enc_stride=cfg.enc_stride,
        extra={"num_spks": cfg.num_spks, "depth": cfg.depth},
    )


def _register_mossformer2_ss():
    from ..models.mossformer2_ss import MossFormer2SS, MossFormer2SsConfig, init_mossformer2_ss

    register(
        ModelSpec(
            name="mossformer2_ss",
            task="separation",
            make_config=MossFormer2SsConfig,
            init_params=init_mossformer2_ss,
            make_module=MossFormer2SS,
            make_manifest=_mossformer2_ss_manifest,
        )
    )


def _gtcrn_stream(cfg):
    from ..models.gtcrn import gtcrn_stream_init, gtcrn_stream_step

    return (partial(gtcrn_stream_init, cfg),
            partial(gtcrn_stream_step, cfg=cfg),
            cfg.n_fft - cfg.hop)


def _register_gtcrn():
    from ..models.gtcrn import GTCRN, GtcrnConfig, init_gtcrn

    register(
        ModelSpec(
            name="gtcrn",
            task="denoise",
            make_config=GtcrnConfig,
            init_params=init_gtcrn,
            make_module=GTCRN,
            make_manifest=_gtcrn_manifest,
            make_stream=_gtcrn_stream,
        )
    )


def _dfsmn_manifest(cfg):
    return Manifest(
        model_name="dfsmn",
        task="denoise",
        model_family="dfsmn",
        in_sample_rate=cfg.in_sample_rate,
        out_sample_rate=cfg.out_sample_rate,
        model_sample_rate=cfg.sample_rate,
        input_audio_length=96000 * cfg.in_sample_rate // 48000,
        window_type="hamming_symmetric",
        nfft=cfg.n_fft,
        window_length=cfg.n_fft,
        hop_length=cfg.hop,
        pad_mode="constant",
        center_pad=False,
        max_dynamic_audio_seconds=6,
        feature_kind="kaldi_fbank_stft",
        fold_window_length=cfg.fold_window,
        batch_fold_inference_default=bool(cfg.fold_window),
        extra={
            "n_mels": cfg.n_mels,
            "kaldi_nfft": cfg.kaldi_nfft,
            "preemph_coeff": cfg.preemph,
            "istft_window_type": "hamming_periodic",
        },
    )


def _dfsmn_stream(cfg):
    from ..models.dfsmn import dfsmn_stream_init, dfsmn_stream_step

    return (partial(dfsmn_stream_init, cfg),
            partial(dfsmn_stream_step, cfg=cfg),
            cfg.n_fft - cfg.hop)


def _register_dfsmn():
    from ..models.dfsmn import DFSMN, DfsmnConfig, init_dfsmn

    register(
        ModelSpec(
            name="dfsmn",
            task="denoise",
            make_config=DfsmnConfig,
            init_params=init_dfsmn,
            make_module=DFSMN,
            make_manifest=_dfsmn_manifest,
            make_stream=_dfsmn_stream,
        )
    )


def _mossformer2_se_manifest(cfg):
    return Manifest(
        model_name="mossformer2_se",
        task="denoise",
        model_family="mossformer2_se",
        in_sample_rate=cfg.in_sample_rate,
        out_sample_rate=cfg.out_sample_rate,
        model_sample_rate=cfg.sample_rate,
        input_audio_length=96000 * cfg.in_sample_rate // 48000,
        window_type="hamming_symmetric",
        nfft=cfg.n_fft,
        window_length=cfg.n_fft,
        hop_length=cfg.hop,
        pad_mode="constant",
        center_pad=False,
        max_dynamic_audio_seconds=6,
        feature_kind="kaldi_fbank_stft",
        fold_window_length=cfg.fold_window,
        batch_fold_inference_default=bool(cfg.fold_window),
        extra={"n_mels": cfg.n_mels, "depth": cfg.depth},
    )


def _register_mossformer2_se():
    from ..models.mossformer2_se import MossFormer2SE, MossFormer2SeConfig, init_mossformer2_se

    register(
        ModelSpec(
            name="mossformer2_se",
            task="denoise",
            make_config=MossFormer2SeConfig,
            init_params=init_mossformer2_se,
            make_module=MossFormer2SE,
            make_manifest=_mossformer2_se_manifest,
        )
    )


def _ul_unas_manifest(cfg):
    return Manifest(
        model_name="ul_unas",
        task="denoise",
        model_family="ul-unas",
        in_sample_rate=cfg.in_sample_rate,
        out_sample_rate=cfg.out_sample_rate,
        model_sample_rate=cfg.sample_rate,
        input_audio_length=32000 * cfg.in_sample_rate // 16000,
        window_type=cfg.window,
        nfft=cfg.n_fft,
        window_length=cfg.n_fft,
        hop_length=cfg.hop,
        pad_mode=cfg.pad_mode,
        center_pad=True,
        fold_window_length=cfg.fold_window,
        batch_fold_inference_default=bool(cfg.fold_window),
    )


def _ul_unas_stream(cfg):
    from ..models.ul_unas import ul_unas_stream_init, ul_unas_stream_step

    return (partial(ul_unas_stream_init, cfg),
            partial(ul_unas_stream_step, cfg=cfg),
            cfg.n_fft - cfg.hop)


def _register_ul_unas():
    from ..models.ul_unas import ULUNAS, UlUnasConfig, init_ul_unas

    register(
        ModelSpec(
            name="ul_unas",
            task="denoise",
            make_config=UlUnasConfig,
            init_params=init_ul_unas,
            make_module=ULUNAS,
            make_manifest=_ul_unas_manifest,
            make_stream=_ul_unas_stream,
        )
    )


def _nkf_manifest(cfg):
    return Manifest(
        model_name="nkf_aec",
        task="aec",
        model_family="nkf",
        in_sample_rate=cfg.in_sample_rate,
        out_sample_rate=cfg.out_sample_rate,
        model_sample_rate=cfg.sample_rate,
        input_audio_length=32000 * cfg.in_sample_rate // 16000,
        window_type=cfg.window,
        nfft=cfg.n_fft,
        window_length=cfg.n_fft,
        hop_length=cfg.hop,
        pad_mode="constant",
        center_pad=True,
        num_audio_inputs=2,
        fold_window_length=cfg.fold_window,
        batch_fold_inference_default=bool(cfg.fold_window),
        extra={"filter_order": cfg.filter_order, "fc_dim": cfg.fc_dim, "rnn_dim": cfg.rnn_dim},
    )


def _nkf_stream(cfg):
    from ..models.nkf_aec import nkf_stream_init, nkf_stream_step

    return (partial(nkf_stream_init, cfg),
            partial(nkf_stream_step, cfg=cfg),
            cfg.n_fft - cfg.hop)


def _register_nkf():
    from ..models.nkf_aec import NKF, NkfConfig, init_nkf

    register(
        ModelSpec(
            name="nkf_aec",
            task="aec",
            make_config=NkfConfig,
            init_params=init_nkf,
            make_module=NKF,
            make_manifest=_nkf_manifest,
            make_stream=_nkf_stream,
        )
    )


def _aec319_manifest(name: str, family: str, cfg, extra: dict):
    """SDAEC's and Deep-Echo's manifest: 10 s windows of (near, far)."""
    return Manifest(
        model_name=name,
        task="aec",
        model_family=family,
        in_sample_rate=cfg.in_sample_rate,
        out_sample_rate=cfg.out_sample_rate,
        model_sample_rate=cfg.sample_rate,
        input_audio_length=160000 * cfg.in_sample_rate // 16000,
        window_type=cfg.window,
        nfft=cfg.n_fft,
        window_length=cfg.n_fft,
        hop_length=cfg.hop,
        pad_mode="constant",
        center_pad=True,
        num_audio_inputs=2,
        max_dynamic_audio_seconds=30,
        extra=extra,
    )


def _sdaec_stream(cfg):
    from ..models.sdaec import sdaec_stream_init, sdaec_stream_step

    return (partial(sdaec_stream_init, cfg),
            partial(sdaec_stream_step, cfg=cfg),
            cfg.n_fft - cfg.hop)


def _register_sdaec():
    from ..models.sdaec import SDAEC, SdaecConfig, init_sdaec

    register(
        ModelSpec(
            name="sdaec",
            task="aec",
            make_config=SdaecConfig,
            init_params=init_sdaec,
            make_module=SDAEC,
            make_manifest=lambda cfg: _aec319_manifest("sdaec", "sdaec", cfg,
                                                       {"alpha_k": cfg.alpha_k}),
            make_stream=_sdaec_stream,
        )
    )


def _deep_echo_stream(cfg):
    from ..models.deep_echo import deep_echo_stream_init, deep_echo_stream_step

    return (partial(deep_echo_stream_init, cfg),
            partial(deep_echo_stream_step, cfg=cfg),
            cfg.n_fft - cfg.hop)


def _register_deep_echo():
    from ..models.deep_echo import DeepEcho, DeepEchoConfig, init_deep_echo

    register(
        ModelSpec(
            name="deep_echo",
            task="aec",
            make_config=DeepEchoConfig,
            init_params=init_deep_echo,
            make_module=DeepEcho,
            make_manifest=lambda cfg: _aec319_manifest("deep_echo", "deep-echo", cfg,
                                                       {"echo_order": cfg.echo_order}),
            make_stream=_deep_echo_stream,
        )
    )


def _dfsmn_aec_manifest(cfg):
    return Manifest(
        model_name="dfsmn_aec",
        task="aec",
        model_family="dfsmn_aec",
        in_sample_rate=cfg.in_sample_rate,
        out_sample_rate=cfg.out_sample_rate,
        model_sample_rate=cfg.sample_rate,
        input_audio_length=32000 * cfg.in_sample_rate // 16000,
        window_type="hamming_symmetric",
        nfft=cfg.frame_len,
        window_length=cfg.frame_len,
        hop_length=cfg.hop,
        center_pad=False,
        num_audio_inputs=2,
        max_dynamic_audio_seconds=30,
        feature_kind="kaldi_fbank_stft",
        extra={"backend": cfg.backend, "n_mels": cfg.n_mels, "output_vad": cfg.output_vad},
    )


def _dfsmn_aec_stream(cfg):
    """The cascade streams with the SDAEC or Deep-Echo backend and no VAD
    output; its latency is 2·hop."""
    from ..models.dfsmn_aec import dfsmn_aec_stream_init, dfsmn_aec_stream_step

    if cfg.output_vad or cfg.backend not in ("sdaec", "deep_echo"):
        raise ValueError("streaming DFSMN-AEC serving needs a streamable backend "
                         "and output_vad=False (use the model API directly for VAD)")
    return (partial(dfsmn_aec_stream_init, cfg),
            partial(dfsmn_aec_stream_step, cfg=cfg),
            2 * cfg.hop)


def _register_dfsmn_aec():
    from ..models.dfsmn_aec import DfsmnAEC, DfsmnAecConfig, init_dfsmn_aec

    register(
        ModelSpec(
            name="dfsmn_aec",
            task="aec",
            make_config=DfsmnAecConfig,
            init_params=init_dfsmn_aec,
            make_module=DfsmnAEC,
            make_manifest=_dfsmn_aec_manifest,
            make_stream=_dfsmn_aec_stream,
        )
    )


def _melband_manifest(cfg):
    return Manifest(
        model_name="melband_roformer" if cfg.channels == 1 else "melband_roformer_stereo",
        task="vocal_separation",
        model_family="mel_band_roformer",
        in_sample_rate=cfg.in_sample_rate,
        out_sample_rate=cfg.out_sample_rate,
        model_sample_rate=cfg.sample_rate,
        input_audio_length=88200 * cfg.in_sample_rate // 44100,
        window_type=cfg.window,
        nfft=cfg.n_fft,
        window_length=cfg.n_fft,
        hop_length=cfg.hop,
        pad_mode=cfg.pad_mode,
        center_pad=True,
        input_channels=cfg.channels,
        output_channels=cfg.channels,
        max_dynamic_audio_seconds=30,
        extra={"num_bands": cfg.num_bands, "dim": cfg.dim, "depth": cfg.depth},
    )


def _register_melband():
    from ..models.melband_roformer import MelBandConfig, MelBandRoformer, init_melband

    for name, make_config in (("melband_roformer", MelBandConfig),
                              ("melband_roformer_stereo", partial(MelBandConfig, channels=2))):
        register(
            ModelSpec(
                name=name,
                task="vocal_separation",
                make_config=make_config,
                init_params=init_melband,
                make_module=MelBandRoformer,
                make_manifest=_melband_manifest,
            )
        )


def _mossformer_sr_manifest(cfg):
    return Manifest(
        model_name="mossformer2_sr",
        task="super_resolution",
        model_family="mossformer2_sr",
        in_sample_rate=cfg.in_sample_rate,
        out_sample_rate=cfg.out_sample_rate,
        model_sample_rate=cfg.out_sample_rate,
        input_audio_length=32000,
        input_to_output_scale=float(cfg.upsample_ratio),
        window_type="hann",
        nfft=cfg.n_fft,
        window_length=cfg.n_fft,
        hop_length=cfg.hop,
        center_pad=False,
        max_dynamic_audio_seconds=30,
        overlap_length=12000,  # Session's Hann-taper OLA overlap (input samples)
        extra={"n_mels": cfg.n_mels, "crossover_hz": cfg.crossover_hz},
    )


def _register_mossformer_sr():
    from ..models.mossformer_sr import (MossFormer2SR, MossFormerSrConfig, init_mossformer_sr,
                                        prepare_params_sr)

    register(
        ModelSpec(
            name="mossformer2_sr",
            task="super_resolution",
            make_config=MossFormerSrConfig,
            init_params=init_mossformer_sr,
            make_module=MossFormer2SR,
            make_manifest=_mossformer_sr_manifest,
            # the HiFi-GAN generator stays float32 in the bf16 plan
            prepare_params=prepare_params_sr,
        )
    )


def _h_gtcrn_manifest(cfg):
    return Manifest(
        model_name="h_gtcrn",
        task="denoise",
        model_family="h-gtcrn",
        in_sample_rate=cfg.in_sample_rate,
        out_sample_rate=cfg.out_sample_rate,
        model_sample_rate=cfg.sample_rate,
        input_audio_length=32000 * cfg.in_sample_rate // 16000,
        window_type=cfg.window,
        nfft=cfg.n_fft,
        window_length=cfg.n_fft,
        hop_length=cfg.hop,
        pad_mode=cfg.pad_mode,
        center_pad=True,
        input_channels=2,
        max_dynamic_audio_seconds=30,
        extra={"rt60": cfg.rt60, "wpe_taps": cfg.wpe_taps, "iva_iter": cfg.iva_iter},
    )


def _register_h_gtcrn():
    from ..models.h_gtcrn import HGTCRN, HGtcrnConfig, init_h_gtcrn

    register(
        ModelSpec(
            name="h_gtcrn",
            task="denoise",
            make_config=HGtcrnConfig,
            init_params=init_h_gtcrn,
            make_module=HGTCRN,
            make_manifest=_h_gtcrn_manifest,
        )
    )


_register_gtcrn()
_register_mossformergan()
_register_zipenhancer()
_register_mossformer2_ss()
_register_dfsmn()
_register_mossformer2_se()
_register_ul_unas()
_register_nkf()
_register_sdaec()
_register_deep_echo()
_register_dfsmn_aec()
_register_melband()
_register_mossformer_sr()
_register_h_gtcrn()
