from .kaldi import KALDI_LOG_EPS, kaldi_analysis_basis, kaldi_mel_banks, log_mel_fbank

__all__ = ["KALDI_LOG_EPS", "kaldi_analysis_basis", "kaldi_mel_banks", "log_mel_fbank"]
