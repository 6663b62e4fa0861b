from repro_torch.kernels.gf2_mvm.ops import gf2_mvm, gf2_mvm_packed
from repro_torch.kernels.gf2_mvm.ref import (gf2_mvm_packed_ref, gf2_mvm_ref,
                                             pack_bits, unpack_bits)

__all__ = ["gf2_mvm", "gf2_mvm_packed", "gf2_mvm_packed_ref", "gf2_mvm_ref",
           "pack_bits", "unpack_bits"]
