"""The color kernel: replicate upsample and YCbCr to RGB."""
