"""The micro-net (SRNet) form: ``srnet`` (model) and ``convert``
(reference checkpoints)."""
