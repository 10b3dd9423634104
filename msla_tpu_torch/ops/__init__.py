"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""
from msla_tpu_torch.ops.conv_stem import conv_stem, conv_stem_ref
from msla_tpu_torch.ops.deconv_stem import deconv_stem, deconv_stem_ref
from msla_tpu_torch.ops.nearest_codes import nearest_codes, nearest_codes_ref

#: every kernel wrapper; each counts its launches in ``.launches``
KERNELS = (conv_stem, deconv_stem, nearest_codes)

__all__ = ["KERNELS", "conv_stem", "conv_stem_ref", "deconv_stem", "deconv_stem_ref",
           "nearest_codes", "nearest_codes_ref"]
