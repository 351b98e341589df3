from . import brusselator, reaction_diffusion  # noqa: F401
