from .em_cost import em_cost, em_cost_ref
from .engine import VX_FLOOR, MCEMConfig
from .fused_engine import mcem_batch_fused
from .mh_chain import mh_chain, mh_chain_ref
from .nmf_sums import nmf_sums, nmf_sums_ref
from .peem import (HybridConfig, PEEMConfig, peem_m1_batch, peem_m2_batch,
                   peem_mcem_m2_batch, peem_run)

__all__ = ["VX_FLOOR", "HybridConfig", "MCEMConfig", "PEEMConfig",
           "em_cost", "em_cost_ref", "mcem_batch_fused", "mh_chain",
           "mh_chain_ref", "nmf_sums", "nmf_sums_ref", "peem_m1_batch",
           "peem_m2_batch", "peem_mcem_m2_batch", "peem_run"]
