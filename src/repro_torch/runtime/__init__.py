"""Serving: the bounded request queue, typed errors and the DCNN server."""
