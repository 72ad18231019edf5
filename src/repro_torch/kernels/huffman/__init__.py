"""Huffman subsequence decoding: the exit and stream-write kernels."""
