"""Utilities: parameter exchange with the JAX package (:mod:`.convert`)."""
