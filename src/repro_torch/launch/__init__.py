"""Launchers (``repro.launch``): the training CLI on one device, the
meshes of virtual devices, and the dry run on the meta device with its
op-level roofline and profile."""
