"""mxnet_tpu_torch.precision — opt-in precision modes (PyTorch counterpart
of ``mxnet_tpu/precision``): bf16 compute, bf16 optimizer state, named
remat policies and the dynamic loss scale.

Entry points::

    mod = mx.mod.Module(net, precision="combined")      # named mode
    mod = mx.mod.Module(net, precision=mx.precision.PrecisionPolicy(
        opt_state_dtype="bfloat16", remat="dots_saveable"))

See :mod:`mxnet_tpu_torch.precision.policy` for the mode table. The
quantized modes (``int8_act``, ``fp8``, ``fp8_native``, ``int8_weight``,
``int8_serve``) are registered by name and refused when bound: they come
with the quant slice of the port.
"""
from .policy import (MODES, PrecisionPolicy, canon_dtype, canon_remat,
                     loss_scale_config, mode_name, register_mode,
                     remat_checkpoint_policy, resolve, state_np_dtype,
                     wrap_fused_apply)

__all__ = ["PrecisionPolicy", "MODES", "resolve", "register_mode",
           "mode_name", "canon_dtype", "canon_remat", "state_np_dtype",
           "wrap_fused_apply", "remat_checkpoint_policy",
           "loss_scale_config"]
