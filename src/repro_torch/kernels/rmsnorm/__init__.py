from repro_torch.kernels.rmsnorm import ops, ref
