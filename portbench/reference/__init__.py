"""The plain reference of a cell's training step: ResNet-50 and AlexNet
in float32 (TF32 off), the gTop-k step with error feedback, the tree of
sparse merges over P workers, and SGD with momentum and weight decay.
Plain PyTorch; it imports neither JAX, nor the JAX package, nor anything
of the port, and works out again from the seed whatever the port derives
(weights, dropout masks, the flat order the selection buckets read)."""
