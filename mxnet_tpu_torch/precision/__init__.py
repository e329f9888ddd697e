"""mxnet_tpu_torch.precision — opt-in precision modes (PyTorch counterpart
of ``mxnet_tpu/precision``): bf16 compute, bf16 optimizer state, named
remat policies, the dynamic loss scale, the low-bit input casts and the
quantized serving modes.

Entry points::

    mod = mx.mod.Module(net, precision="combined")      # named mode
    mod = mx.mod.Module(net, precision=mx.precision.PrecisionPolicy(
        opt_state_dtype="bfloat16", remat="dots_saveable"))
    table = mx.precision.calibrate(eval_module, data_iter)  # int8_serve

See :mod:`mxnet_tpu_torch.precision.policy` for the mode table and
:mod:`mxnet_tpu_torch.precision.quant` for weight-only int8, calibration
and the native int8 / fp8 GEMMs.
"""
from .policy import (MODES, PrecisionPolicy, canon_dtype, canon_remat,
                     fake_cast, loss_scale_config, mode_name, register_mode,
                     remat_checkpoint_policy, resolve, state_np_dtype,
                     to_e4m3, wrap_fused_apply)
from . import quant
from .quant import CalibrationTable, calibrate

__all__ = ["PrecisionPolicy", "MODES", "resolve", "register_mode",
           "mode_name", "canon_dtype", "canon_remat", "state_np_dtype",
           "wrap_fused_apply", "fake_cast", "to_e4m3",
           "remat_checkpoint_policy", "loss_scale_config", "quant",
           "CalibrationTable", "calibrate"]
