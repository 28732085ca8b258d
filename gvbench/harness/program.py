"""The MH-MCEM family's set-up under its former name, for the program's
`scripts/bench_kernels.py --replay`, which imports it; the code is
`families/mh_mcem.py`'s."""

from .layout import HERE, _module

_family = _module(HERE / "families" / "mh_mcem.py", "gvbench_family_mh_mcem")
setup, shapes, entry_kwargs = (_family.setup, _family.shapes,
                               _family.entry_kwargs)
