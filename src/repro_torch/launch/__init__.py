"""Entry points (`repro.launch`): the training driver."""
