from repro_torch.kernels.bitslice_mvm.ops import (bitslice_mvm_planes,
                                                  bitslice_mvm_planes_scaled)
from repro_torch.kernels.bitslice_mvm.ref import (bitslice_mvm_ref,
                                                  bitslice_mvm_scaled_ref)

__all__ = ["bitslice_mvm_planes", "bitslice_mvm_planes_scaled",
           "bitslice_mvm_ref", "bitslice_mvm_scaled_ref"]
