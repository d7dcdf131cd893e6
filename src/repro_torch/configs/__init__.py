"""Published model configurations, one module per architecture, as in
``repro.configs``; only the ported families are here."""
