"""The IDCT kernel: dequant + de-zigzag + IDCT of every data unit."""
