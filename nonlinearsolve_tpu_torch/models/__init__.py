from . import bratu, brusselator, reaction_diffusion, snes_ex2  # noqa: F401
