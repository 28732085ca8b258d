"""The benchmark's harness: traffic, its loops, the program tap, the
correctness check and the reduction of traces to per-layer metrics."""
