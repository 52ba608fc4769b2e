from .parity import output_snr, parity_report
from .profiling import measure_rtf

__all__ = ["measure_rtf", "output_snr", "parity_report"]
