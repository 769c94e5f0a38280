"""Shared utilities: telemetry (spans and counters) and device selection."""

from bundler_sfm_tpu_torch.utils.device import resolve_device  # noqa: F401
from bundler_sfm_tpu_torch.utils.telemetry import (  # noqa: F401
    Telemetry, get_telemetry, stage, counter, span_log,
)
