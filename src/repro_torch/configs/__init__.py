"""Published model configurations, one module per architecture, as in
``repro.configs``: the archs of the ported families (xlstm-1.3b and
zamba2-1.2b wait for theirs), plus the paper's own graph-engine
configuration (alpha_pim_graph)."""
