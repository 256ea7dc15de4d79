"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch twin."""


def all_kernels():
    """Every kernel of the port, as (CudaKernel, replaced TPU kernel)."""
    from iadr1_tpu_torch.kernels import decode_attention, flash_attention

    return [
        (flash_attention.KERNEL,
         "iadr1_tpu/kernels/flash_attention.py:335 _fwd_kernel"),
        (flash_attention.DQ_KERNEL,
         "iadr1_tpu/kernels/flash_attention.py:511 _bwd_dq_kernel"),
        (flash_attention.DKV_KERNEL,
         "iadr1_tpu/kernels/flash_attention.py:587 _bwd_dkv_kernel"),
        (decode_attention.KERNEL,
         "iadr1_tpu/kernels/decode_attention.py:54 _decode_kernel"),
    ]
