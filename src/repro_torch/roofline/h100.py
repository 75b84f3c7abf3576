"""The H100 SXM's peaks, the one place the port's roofline reads them
(`roofline.analysis`, `runtime.costmodel.PodCostModel`). From NVIDIA's
H100 Tensor Core GPU datasheet (SXM5 column) and its DGX H100 system:

- `PEAK_FLOPS`: 989 TFLOP/s of dense bf16 on the tensor cores (the
  datasheet's 1979 counts 2:4 sparsity).
- `HBM_BW`: 3.35 TB/s of HBM3.
- `LINK_BW`: 50 GB/s a GPU: one ConnectX-7 400 Gb/s NDR InfiniBand NIC a
  GPU, the link that bounds a mesh axis spanning more than one node of
  eight GPUs. The production meshes' 256 and 512 ranks span 32 and 64
  such nodes, so their collectives cross it. NVLink's 450 GB/s a
  direction holds only within a node and is the wrong figure for them.
"""
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9
