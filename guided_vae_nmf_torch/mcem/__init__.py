from .engine import VX_FLOOR, MCEMConfig
from .fused_engine import mcem_batch_fused
from .mh_chain import mh_chain, mh_chain_ref
from .nmf_sums import nmf_sums, nmf_sums_ref

__all__ = ["VX_FLOOR", "MCEMConfig", "mcem_batch_fused", "mh_chain",
           "mh_chain_ref", "nmf_sums", "nmf_sums_ref"]
