"""Launchers of the port (``serve``: LM serving on one card)."""
