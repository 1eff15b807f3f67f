"""Launchers of the port (``serve``, ``train``) and what they plan with
(``analytic``, the cost model; ``mesh``, the pipeline's stage
placement)."""
