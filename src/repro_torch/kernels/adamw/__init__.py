from repro_torch.kernels.adamw import ops
