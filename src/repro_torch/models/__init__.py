"""Model registry and models of the port: jpeg-resnet and the dense LMs."""
