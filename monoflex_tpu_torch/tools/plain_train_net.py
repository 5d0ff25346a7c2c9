"""Train / evaluate MonoFlex with the port (the counterpart of the JAX
package's ``tools/plain_train_net.py``, reference CLI parity): a shim onto
``python -m monoflex_tpu_torch.cli``, with its flags::

    python -m monoflex_tpu_torch.tools.plain_train_net --config runs/monoflex.yaml --batch_size 8
    python -m monoflex_tpu_torch.tools.plain_train_net --config runs/monoflex.yaml --eval --ckpt <file>
"""

from monoflex_tpu_torch.cli import main

if __name__ == "__main__":
    main()
