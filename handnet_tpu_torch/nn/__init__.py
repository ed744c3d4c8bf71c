"""Network building blocks of the port (``resnet``, ``fpn``, ``quant``)."""
