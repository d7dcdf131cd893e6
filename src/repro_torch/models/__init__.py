"""The LM stack of the port: configurations, parameter specs and init,
the layers and GQA caches, GQA/MLA/cross attention, the routed MoE and
the model assembly, for the ``dense``, ``audio``, ``moe`` and ``vlm``
families; ``repro.models`` is the JAX counterpart."""
