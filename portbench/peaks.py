"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.  A card that is not listed has
no roofline share."""

PEAKS = {
    # H100 SXM5: 67 TFLOP/s float32 without tensor cores, 3.35 TB/s HBM3
    "NVIDIA H100 80GB HBM3": {"f32_ops_per_s": 67e12, "bytes_per_s": 3.35e12},
}
