from repro_torch.kernels.wkv6 import ops, ref
