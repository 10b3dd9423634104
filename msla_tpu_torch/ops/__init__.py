"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""
from msla_tpu_torch.ops.conv_stem import conv_stem, conv_stem_ref, conv_stem_save_hidden
from msla_tpu_torch.ops.deconv_stem import (deconv_stem, deconv_stem_ref,
                                            deconv_stem_save_hidden)
from msla_tpu_torch.ops.flash_attn import attention_ref, flash_attn, scaled_attention
from msla_tpu_torch.ops.mlm_argmax import mlm_argmax, mlm_argmax_conf, mlm_argmax_ref
from msla_tpu_torch.ops.nearest_codes import nearest_codes, nearest_codes_ref
from msla_tpu_torch.ops.vq_fused import (vq_codebook_grad, vq_codebook_grad_ref,
                                         vq_fused_fwd, vq_fused_fwd_ref)
from msla_tpu_torch.ops.vq_lean import vq_lean_fwd, vq_lean_fwd_ref
from msla_tpu_torch.ops.vq_precision import (vq_precision_bwd, vq_precision_bwd_ref,
                                             vq_precision_fwd, vq_precision_fwd_ref)

#: every kernel wrapper; each counts its launches in ``.launches``, a Counter
#: by operand type that ``_build.launch_count`` reads
KERNELS = (conv_stem, deconv_stem, nearest_codes, conv_stem_save_hidden,
           deconv_stem_save_hidden, vq_fused_fwd, vq_codebook_grad, mlm_argmax,
           mlm_argmax_conf, flash_attn, vq_lean_fwd, vq_precision_fwd, vq_precision_bwd)

__all__ = ["KERNELS", "attention_ref", "conv_stem", "conv_stem_ref", "conv_stem_save_hidden",
           "deconv_stem", "deconv_stem_ref", "deconv_stem_save_hidden", "flash_attn",
           "mlm_argmax", "mlm_argmax_conf", "mlm_argmax_ref", "nearest_codes",
           "nearest_codes_ref", "scaled_attention", "vq_codebook_grad",
           "vq_codebook_grad_ref", "vq_fused_fwd", "vq_fused_fwd_ref", "vq_lean_fwd",
           "vq_lean_fwd_ref", "vq_precision_bwd", "vq_precision_bwd_ref", "vq_precision_fwd",
           "vq_precision_fwd_ref"]
