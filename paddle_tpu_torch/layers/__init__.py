"""The v2 layer surface of the port (``paddle_tpu/layers``): graph nodes,
attributes, activations, pooling types, input types and the layer
constructors of the image path."""
