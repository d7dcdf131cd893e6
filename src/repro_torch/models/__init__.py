"""The LM stack of the port: configurations, parameter specs and init,
the layers, MLA attention, the routed MoE and the model assembly, for the
``moe`` family (DeepSeek-V2-Lite); ``repro.models`` is the JAX
counterpart."""
