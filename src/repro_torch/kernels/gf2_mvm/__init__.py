from repro_torch.kernels.gf2_mvm.ops import gf2_mvm
from repro_torch.kernels.gf2_mvm.ref import gf2_mvm_ref

__all__ = ["gf2_mvm", "gf2_mvm_ref"]
