"""Neural Object Field (NOF) training in PyTorch: the field as an
`nn.Module`, SDF volume rendering, losses, the Adam step and the runner.
"""
from bundlesdf_tpu_torch.nof.models import NofField, NofSpec, params_from_jax
from bundlesdf_tpu_torch.nof.runner import NofRunner
