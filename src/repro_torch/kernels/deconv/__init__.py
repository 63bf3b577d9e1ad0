"""Deconv kernel subsystem."""
