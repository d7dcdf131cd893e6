"""Published model configurations, one module per architecture, as in
``repro.configs``; only the ported families are here, plus the paper's own
graph-engine configuration (alpha_pim_graph)."""
