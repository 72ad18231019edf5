"""The LM/VLM substrate: configs, layers and the model, for serving every
family of the JAX package on one card (ROADMAP A11a, A11b)."""
