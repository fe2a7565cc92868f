"""Utilities: parameter exchange with the JAX package (:mod:`.convert`) and
the fit history and logger (:mod:`.metrics`)."""
