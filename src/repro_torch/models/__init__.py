"""Model code of the port: the shared layers, attention, the Mamba-2
mixer (``ssm.py``) and the decoder LM of the ported block kinds
(``transformer.py``)."""
