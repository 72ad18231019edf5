"""The LM/VLM substrate: configs, layers and the model, for serving the
dense decoder-only and VLM families on one card (ROADMAP A11a)."""
