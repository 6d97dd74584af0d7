"""The paper's task models, in PyTorch."""
