"""The tap on the program: it wraps the entry the window drives
(`pipeline.enhance_waveform`, as the sweep calls it or as the service's
collector thread calls it), and installs the cell's family's hooks
(`families/<name>.py`'s `install`), without copying anything.

For every entry call it notes the batch (real rows, valid frames, time).
For one armed call it keeps references to the call's inputs and outputs
in a record, which the family's hooks fill with the state its check
follows (`armed_record()` gives them the record of the armed call running
in their thread); `i_sel` in the record is the family's `pick_judged`.

In a traced run it also starts `torch.profiler` at the first entry call
past `profile_from` seconds into the window and stops it at the first
call `profile_s` seconds after that, both in the calling thread (the
profiler records host spans of that thread only), after a device
synchronisation, so the profile holds exactly the device work of the
batches called in between.
"""

import threading
import time

import numpy as np
import torch


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Tap:
    def __init__(self, armed=None, i_sel=0, trace=False, profile_from=None,
                 profile_s=None):
        self.armed = armed
        self.i_sel = i_sel
        self.trace = trace
        self.profile_from = profile_from
        self.profile_s = profile_s
        self.window_t0 = None
        self.calls = 0
        self.batches = []
        self.record = None
        self.prof = None
        self.prof_span = None          # (first call, end call, seconds)
        self._prof_t = None
        self._local = threading.local()
        self._undo = []

    # -- installing -------------------------------------------------------

    def install(self, owner, family):
        """Wrap `owner.enhance_waveform`, and install the family's hooks."""
        self._entry_fn = owner.enhance_waveform
        owner.enhance_waveform = self.entry
        self._undo = [(owner, "enhance_waveform", self._entry_fn)]
        self._undo += family.install(self)
        return self

    def uninstall(self):
        for obj, name, fn in self._undo:
            setattr(obj, name, fn)
        self._undo = []

    def start_window(self):
        self.window_t0 = time.perf_counter()
        self.calls = 0
        self.batches = []

    # -- profiling --------------------------------------------------------

    def _profile_edge(self, idx):
        if not self.trace or self.window_t0 is None:
            return
        now = time.perf_counter()
        if self.prof is None and now - self.window_t0 >= self.profile_from:
            from torch.profiler import ProfilerActivity, profile

            _sync()
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self._prof_t = (idx, time.perf_counter())
        elif (self.prof is not None and self.prof_span is None
              and now - self._prof_t[1] >= self.profile_s):
            self.stop_profile(idx)

    def stop_profile(self, idx=None):
        """Stop the profiler (after a synchronisation) if it runs; the
        profiled batches are the calls from its start to `idx`."""
        if self.prof is None or self.prof_span is not None:
            return
        _sync()
        t1 = time.perf_counter()
        self.prof.stop()
        first, t0 = self._prof_t
        self.prof_span = (first, self.calls if idx is None else idx, t1 - t0)

    # -- the wrapper ------------------------------------------------------

    def armed_record(self):
        """The record of the armed call running in this thread, or None."""
        return getattr(self._local, "rec", None)

    def entry(self, model, x_pad, mask, cfg, **kw):
        idx = self.calls
        self.calls += 1
        self._profile_edge(idx)
        seeds = [int(s) for s in kw.get("seeds") or []]
        mask_np = np.asarray(mask)
        real = len(dict.fromkeys(seeds)) if seeds else len(mask_np)
        info = {"idx": idx, "rows": real, "n_pad": mask_np.shape[1],
                "frames": float(mask_np[:real].sum()),
                "t0": time.perf_counter()}
        rec = None
        if idx == self.armed and self.window_t0 is not None:
            gen = kw.get("generator")
            rec = {"x_pad": np.array(x_pad), "mask": mask_np.copy(),
                   "seeds": seeds, "rows": real, "cfg": cfg,
                   "gen_seed": None if gen is None else gen.initial_seed(),
                   "kw": {k: v for k, v in kw.items()
                          if k not in ("generator", "seeds", "classifier",
                                       "mean", "std")},
                   "i_sel": self.i_sel}
            self._local.rec = rec
        try:
            out = self._entry_fn(model, x_pad, mask, cfg, **kw)
        finally:
            self._local.rec = None
        info["t1"] = time.perf_counter()
        self.batches.append(info)
        if rec is not None:
            rec["out"] = out
            self.record = rec
        return out
