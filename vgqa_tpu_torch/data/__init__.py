"""Host-side data: tokenizer, video decode, batch collation (counterpart of
``vgqa_tpu.data``)."""
