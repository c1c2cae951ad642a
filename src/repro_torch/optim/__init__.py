"""Optimizers that consume the LAQ aggregate (port of ``repro/optim``)."""
