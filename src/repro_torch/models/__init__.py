"""Model zoo (port of ``repro.models``): the ten architectures' blocks as
``nn.Module``s, their forward, prefill into decode caches and one-token
decode over ragged lanes."""
