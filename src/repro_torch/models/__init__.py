"""Model registry of the port (the jpeg-resnet family)."""
