"""Published model configurations, one module per architecture, as in
``repro.configs``: the ten archs of the LM zoo, plus the paper's own
graph-engine configuration (alpha_pim_graph)."""
