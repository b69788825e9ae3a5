"""Plain float32 reference of VSTGNet: frozen copies of the port's model
modules (``vstgnet``, ``resnet``, ``video_swin``, ``roberta``, ``encoder``,
``decoder``, ``layers``, ``bert_blocks``, ``loss``, ``postprocess``,
``optimizer`` and their helpers) with every kernel call replaced by the
plain torch function of ``plain_kernels``. Nothing here imports the port."""
