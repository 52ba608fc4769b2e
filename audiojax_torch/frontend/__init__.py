from .kaldi import KALDI_LOG_EPS, kaldi_analysis_basis, kaldi_mel_banks, log_mel_fbank
from .mel import hz_to_mel_slaney, mel_to_hz_slaney, slaney_mel_fbanks

__all__ = ["KALDI_LOG_EPS", "kaldi_analysis_basis", "kaldi_mel_banks", "log_mel_fbank",
           "hz_to_mel_slaney", "mel_to_hz_slaney", "slaney_mel_fbanks"]
