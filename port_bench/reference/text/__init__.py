from . import frontend, g2p, phonology, symbols  # noqa: F401
