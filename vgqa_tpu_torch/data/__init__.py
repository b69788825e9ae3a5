"""Host-side data (counterpart of ``vgqa_tpu.data``): tokenizer, video
decode, VidSTG annotations, clip sampling, transforms, the dataset, the
loader, batch collation, the synthetic dataset and the VidSTG metrics."""
