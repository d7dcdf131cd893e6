"""Launchers (``repro.launch``): the training CLI on one device."""
