"""Training runtime of the port: AdamW, the train-step factory, the
trainer loop and int8 gradient compression."""
