"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""
from msla_tpu_torch.ops.conv_stem import conv_stem, conv_stem_ref, conv_stem_save_hidden
from msla_tpu_torch.ops.deconv_stem import (deconv_stem, deconv_stem_ref,
                                            deconv_stem_save_hidden)
from msla_tpu_torch.ops.nearest_codes import nearest_codes, nearest_codes_ref
from msla_tpu_torch.ops.vq_fused import (vq_codebook_grad, vq_codebook_grad_ref,
                                         vq_fused_fwd, vq_fused_fwd_ref)

#: every kernel wrapper; each counts its launches in ``.launches``
KERNELS = (conv_stem, deconv_stem, nearest_codes, conv_stem_save_hidden,
           deconv_stem_save_hidden, vq_fused_fwd, vq_codebook_grad)

__all__ = ["KERNELS", "conv_stem", "conv_stem_ref", "conv_stem_save_hidden", "deconv_stem",
           "deconv_stem_ref", "deconv_stem_save_hidden", "nearest_codes",
           "nearest_codes_ref", "vq_codebook_grad", "vq_codebook_grad_ref", "vq_fused_fwd",
           "vq_fused_fwd_ref"]
