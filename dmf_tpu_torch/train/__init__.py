"""Training of the single-modality encoder: grouped AdamW with per-group
hyperparameters (``optim``), the schedulers (``schedule``), the train state
(``state``), the train and eval steps (``single``) and the epoch loop
(``loop``).  Counterpart of ``dmf_tpu/train`` without fusion training and the
fold-parallel loop."""
