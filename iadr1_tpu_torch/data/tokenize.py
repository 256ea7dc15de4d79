"""Label masking constant (the port's own copy of what it needs from
iadr1_tpu/data/tokenize.py): label positions set to IGNORE_INDEX carry no
loss."""

IGNORE_INDEX = -100
