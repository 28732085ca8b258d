from .profiling import (StageTimer, device_time_ms, profile_trace,
                        reset_spans, span, span_records)

__all__ = ["StageTimer", "device_time_ms", "profile_trace", "reset_spans",
           "span", "span_records"]
