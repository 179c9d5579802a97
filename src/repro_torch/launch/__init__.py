"""Launchers (port of ``repro.launch``): ``train`` for the vision models."""
