from repro_torch.kernels.decode_attention import ops, ref
