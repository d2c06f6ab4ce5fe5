"""Component registries (DATASET/ARCH/MODEL/LOSS/METRIC/TRAINER).
Counterpart of `ucdir_tpu/utils/registry.py` (the port keeps its own copy).

Parity target: utils/registry.py:4-75. The reference defines
these but mostly uses string->getattr dispatch; kept here for API parity and
for user extension (`@DATASET_REGISTRY.register()` on custom datasets).
"""
from __future__ import annotations


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map = {}

    def _do_register(self, name: str, obj):
        assert name not in self._obj_map, (
            f"An object named '{name}' was already registered "
            f"in '{self._name}' registry!")
        self._obj_map[name] = obj

    def register(self, obj=None):
        if obj is None:
            def deco(func_or_class):
                self._do_register(func_or_class.__name__, func_or_class)
                return func_or_class
            return deco
        self._do_register(obj.__name__, obj)
        return obj

    def get(self, name: str):
        ret = self._obj_map.get(name)
        if ret is None:
            raise KeyError(
                f"No object named '{name}' found in '{self._name}' registry!")
        return ret

    def __contains__(self, name: str):
        return name in self._obj_map

    def __iter__(self):
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()


DATASET_REGISTRY = Registry('dataset')
ARCH_REGISTRY = Registry('arch')
MODEL_REGISTRY = Registry('model')
LOSS_REGISTRY = Registry('loss')
METRIC_REGISTRY = Registry('metric')
TRAINER_REGISTRY = Registry('trainer')
