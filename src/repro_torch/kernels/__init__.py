# Hand-written CUDA kernels for the join's distance hot spot (csrc/*.cu,
# built by _build.py) with their plain PyTorch versions (ref.py) and the
# dispatcher that picks one by device (ops.py):
#   pairwise_sq_dists  tiled CUDA-core f32 GEMM + distance epilogue
#   rowwise_sq_dists   warp-per-pair difference form over (B, K, d) rows
#   gather_sq_dists    the same, reading rows by id from the vector table
#   *_int8             int8 pairwise (__dp4a tile) and rowwise/gather forms
#   topk_merge         rank-select merge of a sorted beam with candidates
#   *_hamming          sketch XOR + __popc, pairwise tile and gather forms
#   *_pdx              PDX slab-by-slab distances with certified early exit
