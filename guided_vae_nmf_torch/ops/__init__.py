from .profiling import StageTimer, device_time_ms, profile_trace, stage

__all__ = ["StageTimer", "device_time_ms", "profile_trace", "stage"]
