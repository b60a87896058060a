"""Hierarchical YAML configuration engine (the port's own copy of
``kge_tpu/config.py``).

Every experiment knob is a documented YAML option with a default,
accessed by dotted key. Distinctive features:

- dotted-key ``get``/``set`` with type checking against the default value
- ``get_default``: ``<parent>.type``-indirected default resolution
  (reference: kge/config.py:73-118)
- ``+++`` wildcard keys marking user-extensible subtrees
  (reference: kge/config.py:60-70)
- module imports: per-component ``<name>.yaml`` files merged into the
  config (reference ``_import``, kge/config.py:248-293)
- human log (``kge.log``) and machine-readable single-line-YAML trace
  (``trace.yaml``) sinks (reference: kge/config.py:408-456)

Configs and checkpoints written by ``kge_tpu`` load unchanged: a loaded
``modules`` list names the JAX package's modules, and
``load_options`` rewrites each ``kge_tpu.*`` entry to its
``kge_tpu_torch.*`` counterpart (entries the port does not have yet are
dropped), so a class or YAML lookup never imports the JAX package.
``save_to`` writes the options back in ``kge_tpu``'s form, so a
checkpoint written here loads in either package.
"""

from __future__ import annotations

import copy
import datetime
import importlib.util
import os
import time
import uuid
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

import yaml

_REFERENCE_PACKAGE = "kge_tpu"
_PORT_PACKAGE = "kge_tpu_torch"


def _is_mapping(x) -> bool:
    return isinstance(x, dict)


def _rename_package(name: str, old: str, new: str) -> str:
    if name == old or name.startswith(old + "."):
        return new + name[len(old):]
    return name


def port_modules(modules: List[str]) -> List[str]:
    """``kge_tpu.*`` module names -> the port's counterparts; modules the
    port does not have (yet) are dropped, other names pass through."""
    result = []
    for name in modules:
        ported = _rename_package(name, _REFERENCE_PACKAGE, _PORT_PACKAGE)
        if ported != name and importlib.util.find_spec(ported) is None:
            continue
        result.append(ported)
    return result


def _coerce_number(value):
    """Coerce a string to int/float when it parses cleanly."""
    if not isinstance(value, str):
        return value
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


class Config:
    """A nested-dict configuration with dotted-key access.

    All available options with defaults live in ``config-default.yaml``
    next to this module.
    """

    Overwrite = Enum("Overwrite", "Yes No Error")

    def __init__(self, folder: Optional[str] = None, load_default: bool = True):
        if load_default:
            with open(Config.default_filename(), "r") as f:
                self.options: Dict[str, Any] = yaml.safe_load(f)
            for m in self.get("import"):
                self._import(m)
        else:
            self.options = {}
        self.folder = folder
        self.log_folder: Optional[str] = None
        self.log_prefix: Optional[str] = None

    @staticmethod
    def default_filename() -> str:
        return os.path.join(os.path.dirname(__file__), "config-default.yaml")

    # ------------------------------------------------------------------ access

    def get(self, key: str, remove_plusplusplus: bool = True) -> Any:
        """Return the value at dotted ``key``; raise KeyError if absent."""
        node = self.options
        for part in key.split("."):
            try:
                node = node[part]
            except (KeyError, TypeError):
                raise KeyError(f"config key '{key}' not found (missing '{part}')")
        if remove_plusplusplus and _is_mapping(node):
            node = copy.deepcopy(node)

            def strip(d):
                if _is_mapping(d):
                    d.pop("+++", None)
                    for v in d.values():
                        strip(v)

            strip(node)
        return node

    def get_default(self, key: str) -> Any:
        """Return value of ``key``, falling back to type-indirected defaults.

        If ``a.b.c`` is absent and ``a.b.type`` holds ``t``, retry ``t.c``;
        if no ``type`` is found, walk up one level and repeat. Mirrors the
        reference's resolution order exactly.
        """
        try:
            return self.get(key)
        except KeyError as original:
            dot = key.rfind(".")
            if dot < 0:
                raise original
            parent, field = key[:dot], key[dot + 1 :]
            seen = set()  # cycle guard: a.type: a (or a<->b) must raise
            while True:
                if (parent, field) in seen:
                    raise original
                seen.add((parent, field))
                try:
                    ptype = self.get(parent + ".type")
                except KeyError:
                    # no type here: hoist one level and retry
                    dot = parent.rfind(".")
                    if dot < 0:
                        raise original
                    field = parent[dot + 1 :] + "." + field
                    parent = parent[:dot]
                    continue
                redirected = ptype + "." + field
                dot = redirected.rfind(".")
                parent, field = redirected[:dot], redirected[dot + 1 :]
                try:
                    return self.get(parent + "." + field)
                except KeyError:
                    continue

    def get_first_present_key(self, *keys: str, use_get_default: bool = False) -> str:
        for key in keys:
            try:
                self.get_default(key) if use_get_default else self.get(key)
                return key
            except KeyError:
                pass
        raise KeyError(f"none of the keys {keys} found")

    def get_first(self, *keys: str, use_get_default: bool = False) -> Any:
        key = self.get_first_present_key(*keys, use_get_default=use_get_default)
        return self.get_default(key) if use_get_default else self.get(key)

    def exists(self, key: str) -> bool:
        try:
            self.get(key)
            return True
        except KeyError:
            return False

    # ------------------------------------------------------------------ mutation

    def set(self, key: str, value, create: bool = False, overwrite=Overwrite.Yes,
            log: bool = False) -> Any:
        """Set ``key`` to ``value``.

        Creating previously-absent keys requires ``create=True`` or an
        enclosing subtree marked extensible with ``+++``. Types of existing
        values are enforced (with str->number coercion for CLI input).
        """
        parts = key.split(".")
        node = self.options
        for i, part in enumerate(parts[:-1]):
            if part in node:
                if _is_mapping(node[part]) and "+++" in node[part]:
                    create = True
            else:
                if not create:
                    raise KeyError(
                        f"cannot set '{key}': '{'.'.join(parts[: i + 1])}' does not "
                        "exist and key creation is not allowed here"
                    )
                node[part] = {}
            node = node[part]
            if not _is_mapping(node):
                raise KeyError(f"cannot set '{key}': '{part}' is not a mapping")

        leaf = parts[-1]
        current = node.get(leaf)
        if current is None and leaf not in node:
            if not create:
                raise KeyError(
                    f"cannot set '{key}': key does not exist and key creation "
                    "is not allowed here"
                )
            value = _coerce_number(value)
        elif current is not None:
            if isinstance(value, str) and isinstance(current, (list, dict)):
                # structured flag values from the CLI arrive as strings
                parsed = yaml.safe_load(value)
                if isinstance(parsed, type(current)):
                    value = parsed
            if isinstance(value, str) and isinstance(current, bool):
                # CLI flag strings for bool options ("True"/"false"/"on")
                lowered = value.strip().lower()
                if lowered in ("true", "1", "yes", "on"):
                    value = True
                elif lowered in ("false", "0", "no", "off"):
                    value = False
            if isinstance(value, str) and isinstance(current, (int, float)) and not isinstance(current, bool):
                coerced = _coerce_number(value)
                if isinstance(coerced, (int, float)):
                    value = type(current)(coerced)
            if isinstance(value, int) and not isinstance(value, bool) and isinstance(current, float):
                value = float(value)
            if type(value) is not type(current):
                raise ValueError(
                    f"key '{key}' has incorrect type (expected "
                    f"{type(current).__name__}, got {type(value).__name__})"
                )
            if overwrite == Config.Overwrite.No:
                return current
            if overwrite == Config.Overwrite.Error and value != current:
                raise ValueError(f"key '{key}' cannot be overwritten")
        node[leaf] = value
        if log:
            self.log(f"Set {key}={value!r} (was {current!r})")
        return value

    def set_all(self, new_options: Dict[str, Any], create: bool = False,
                overwrite=Overwrite.Yes):
        for key, value in Config.flatten(new_options).items():
            self.set(key, value, create, overwrite)

    # ------------------------------------------------------------------ imports

    def modules(self) -> List[str]:
        return self.get("modules")

    def _import(self, module_name: str):
        """Merge ``<module_name>.yaml`` (searched in configured module dirs).

        Existing values in this config take precedence over imported
        defaults; imported files may declare new keys freely.
        """
        from kge_tpu_torch.utils.misc import filename_in_module

        imported = Config(load_default=False)
        imported.set("modules", self.get_default("modules"), create=True)
        path = filename_in_module(self.modules(), f"{module_name}.yaml")
        imported.load(path, create=True)
        imported.options.pop("import", None)

        # existing values win over imported defaults
        for key in list(imported.options.keys()):
            try:
                existing = {key: self.get(key)}
            except KeyError:
                continue
            imported.set_all(existing, create=False)
        self.set_all(imported.options, create=True)

        imports = self.options.get("import")
        if imports is None:
            imports = [module_name]
        elif isinstance(imports, str):
            imports = [imports, module_name]
        else:
            imports = list(dict.fromkeys([*imports, module_name]))
        self.options["import"] = imports

    # ------------------------------------------------------------------ load/save

    def load(self, filename: str, create: bool = False, overwrite=Overwrite.Yes):
        with open(filename, "r") as f:
            new_options = yaml.safe_load(f)
        if new_options is not None:
            self.load_options(new_options, create=create, overwrite=overwrite)

    #: Migration tables for old LibKGE configs (reference:
    #: kge/config.py:661-869). Exact-key renames, whole-prefix renames,
    #: and per-key value renames; applied to every loaded options dict so
    #: historical configs keep working against the current schema.
    DEPRECATED_KEYS: Dict[str, str] = {
        "entity_ranking.tie_handling": "entity_ranking.tie_handling.type",
        "eval.tie_handling": "entity_ranking.tie_handling.type",
        "train.optimizer": "train.optimizer.default.type",
        "eval.filter_splits": "entity_ranking.filter_splits",
        "eval.filter_with_test": "entity_ranking.filter_with_test",
        "valid.filter_with_test": "entity_ranking.filter_with_test",
        "eval.hits_at_k_s": "entity_ranking.hits_at_k_s",
        "eval.chunk_size": "entity_ranking.chunk_size",
        "eval.data": "eval.split",
        "eval.metrics_per_relation_type":
            "entity_ranking.metrics_per.relation_type",
        "eval.metrics_per_head_and_tail":
            "entity_ranking.metrics_per.head_and_tail",
        "eval.metric_per_argument_frequency_perc":
            "entity_ranking.metrics_per.argument_frequency",
        "negative_sampling.chunk_size": "train.subbatch_size",
        "negative_sampling.score_func_type":
            "negative_sampling.implementation",
        "checkpoint.every": "train.checkpoint.every",
        "checkpoint.keep": "train.checkpoint.keep",
        **{
            f"negative_sampling.num_samples_{s}":
                f"negative_sampling.num_samples.{s}"
            for s in "spo"
        },
        **{
            f"negative_sampling.num_negatives_{s}":
                f"negative_sampling.num_samples.{s}"
            for s in "spo"
        },
        **{
            f"negative_sampling.filter_positives_{s}":
                f"negative_sampling.filtering.{s}"
            for s in "spo"
        },
        **{
            f"negative_sampling.filter_true_{s}":
                f"negative_sampling.filtering.{s}"
            for s in "spo"
        },
    }

    #: old prefix -> new prefix (applied after exact-key renames)
    DEPRECATED_PREFIXES: List[Tuple[str, str]] = [
        ("train.optimizer_args.", "train.optimizer.default.args."),
        ("eval.metrics_per.", "entity_ranking.metrics_per."),
        ("valid.early_stopping.min_threshold.",
         "valid.early_stopping.threshold."),
        ("1toN.", "KvsAll."),
        ("inverse_relations_model.", "reciprocal_relations_model."),
    ]

    #: (key, old value) -> new value
    DEPRECATED_VALUES: Dict[Tuple[str, Any], Any] = {
        ("search.type", "ax"): "ax_search",
        ("search.type", "manual"): "manual_search",
        ("search.type", "grid"): "grid_search",
        ("negative_sampling.implementation", "spo"): "triple",
        ("negative_sampling.implementation", "sp_po"): "batch",
        ("train.type", "1toN"): "KvsAll",
        ("train.type", "spo"): "1vsAll",
        ("train.loss", "ce"): "kl",
        ("train.lr_scheduler", "ConstantLRScheduler"): "",
        ("model", "inverse_relations_model"): "reciprocal_relations_model",
    }

    def _rewrite_deprecated(self, options: Dict[str, Any]) -> Dict[str, Any]:
        flat = Config.flatten(options)
        rewritten: Dict[str, Any] = {}
        for key, value in flat.items():
            new_key = Config.DEPRECATED_KEYS.get(key, key)
            for old_prefix, new_prefix in Config.DEPRECATED_PREFIXES:
                if new_key.startswith(old_prefix):
                    new_key = new_prefix + new_key[len(old_prefix):]
            try:
                value = Config.DEPRECATED_VALUES.get((new_key, value), value)
            except TypeError:
                pass  # unhashable value (list/dict leaf)
            if new_key != key:
                self.log(f"Renamed deprecated key {key} -> {new_key}")
            if new_key in rewritten and rewritten[new_key] != value:
                raise ValueError(
                    f"deprecated key {key} and its replacement {new_key} "
                    "are both set with different values"
                )
            rewritten[new_key] = value
        return rewritten

    def load_options(self, new_options: Dict[str, Any], create: bool = False,
                     overwrite=Overwrite.Yes):
        """Like load() but from an already-parsed options dict. The input
        dict is not modified (checkpoint dicts get reused by callers)."""
        new_options = copy.deepcopy(new_options)
        if Config.DEPRECATED_KEYS:
            new_options = self._rewrite_deprecated(new_options)
        if "modules" in new_options:
            merged = list(dict.fromkeys([
                *self.options.get("modules", []),
                *port_modules(new_options["modules"]),
            ]))
            self.set("modules", merged, create=True)
            del new_options["modules"]
        if new_options.get("model"):
            self._import(new_options["model"])
        if "import" in new_options:
            imports = new_options["import"]
            if not isinstance(imports, list):
                imports = [imports]
            for m in imports:
                self._import(m)
            del new_options["import"]
        self.set_all(new_options, create=create, overwrite=overwrite)

    def load_config(self, config: "Config", create: bool = False,
                    overwrite=Overwrite.Yes):
        self.load_options(copy.deepcopy(config.options), create=create,
                          overwrite=overwrite)

    def save(self, filename: str):
        with open(filename, "w+") as f:
            f.write(yaml.dump(self.options, default_flow_style=False))

    def save_to(self, checkpoint: Dict) -> Dict:
        """Embed this config into a checkpoint dict as a plain options
        dict whose ``modules`` name ``kge_tpu``'s modules: unpickling it
        imports neither package, and both load it through
        ``Config.create_from``."""
        options = copy.deepcopy(self.options)
        options["modules"] = list(dict.fromkeys(
            _rename_package(m, _PORT_PACKAGE, _REFERENCE_PACKAGE)
            for m in options.get("modules", [])
        ))
        checkpoint["config"] = options
        return checkpoint

    @staticmethod
    def create_from(checkpoint: Dict) -> "Config":
        """Rebuild a Config from a checkpoint (reference: config.py:559-574)."""
        config = Config()
        if checkpoint.get("config"):
            other = checkpoint["config"]
            if isinstance(other, Config):
                config.load_config(other, create=True)
            else:
                config.load_options(other, create=True)
        if checkpoint.get("folder"):
            config.folder = checkpoint["folder"]
        return config

    # ------------------------------------------------------------------ helpers

    @staticmethod
    def flatten(options: Dict[str, Any]) -> Dict[str, Any]:
        result: Dict[str, Any] = {}
        Config._flatten(options, result, prefix="")
        return result

    @staticmethod
    def _flatten(options, result, prefix):
        for key, value in options.items():
            full = f"{prefix}{key}"
            if _is_mapping(value):
                Config._flatten(value, result, prefix=full + ".")
            else:
                result[full] = value

    def clone(self, subfolder: Optional[str] = None) -> "Config":
        other = Config(folder=self.folder, load_default=False)
        other.options = copy.deepcopy(self.options)
        if subfolder is not None:
            other.folder = os.path.join(self.folder, subfolder)
        return other

    def check(self, key: str, allowed_values: List[Any]) -> Any:
        value = self.get(key)
        if value not in allowed_values:
            raise ValueError(
                f"illegal value {value!r} for key {key}; allowed: {allowed_values}"
            )
        return value

    def check_default(self, key: str, allowed_values: List[Any]) -> Any:
        value = self.get_default(key)
        if value not in allowed_values:
            raise ValueError(
                f"illegal value {value!r} for key {key}; allowed: {allowed_values}"
            )
        return value

    def check_range(self, key: str, min_value, max_value,
                    min_inclusive: bool = True, max_inclusive: bool = True) -> Any:
        value = self.get(key)
        if (value < min_value or (value == min_value and not min_inclusive)
                or value > max_value or (value == max_value and not max_inclusive)):
            raise ValueError(f"illegal value {value!r} for key {key}")
        return value

    # ------------------------------------------------------------------ logging

    def logfile(self) -> str:
        folder = self.log_folder if self.log_folder else self.folder
        return os.path.join(folder, "kge.log") if folder else os.devnull

    def tracefile(self) -> str:
        folder = self.log_folder if self.log_folder else self.folder
        return os.path.join(folder, "trace.yaml") if folder else os.devnull

    def log(self, msg: str, echo: bool = True, prefix: str = ""):
        with open(self.logfile(), "a") as f:
            for line in msg.splitlines():
                if prefix:
                    line = prefix + line
                if self.log_prefix:
                    line = self.log_prefix + line
                # tolerate configs without defaults loaded (e.g. the
                # bare module configs built inside _import): treat a
                # missing console.quiet as not-quiet
                try:
                    quiet = bool(self.get("console.quiet"))
                except KeyError:
                    quiet = False
                if echo and not quiet:
                    print(line)
                f.write(f"{datetime.datetime.now()} {line}\n")

    def trace(self, echo: bool = False, echo_prefix: str = "", log: bool = False,
              **kwargs) -> Dict[str, Any]:
        """Append a single-line YAML record to trace.yaml; return the entry."""
        kwargs["timestamp"] = time.time()
        kwargs["entry_id"] = str(uuid.uuid4())
        line = yaml.dump(kwargs, width=float("inf"), default_flow_style=True).strip()
        if echo or log:
            msg = yaml.dump(kwargs, default_flow_style=self.get("console.quiet"))
            if log:
                self.log(msg, echo=echo, prefix=echo_prefix)
            elif echo and not self.get("console.quiet"):
                for ln in msg.splitlines():
                    print(echo_prefix + ln)
        with open(self.tracefile(), "a") as f:
            f.write(line + "\n")
        return kwargs

    # ------------------------------------------------------------------ folders

    def init_folder(self) -> bool:
        """Create experiment folder and persist config.yaml; True if created."""
        if not self.folder:
            raise ValueError("no experiment folder configured")
        if not os.path.exists(self.folder):
            os.makedirs(self.folder)
            os.makedirs(os.path.join(self.folder, "config"))
            self.save(os.path.join(self.folder, "config.yaml"))
            return True
        return False

    def checkpoint_file(self, cpt_id) -> str:
        """Path of checkpoint file for epoch number or name (e.g. 'best')."""
        from kge_tpu_torch.utils.misc import is_number

        if is_number(cpt_id, int):
            return os.path.join(self.folder, f"checkpoint_{int(cpt_id):05d}.pt")
        return os.path.join(self.folder, f"checkpoint_{cpt_id}.pt")

    def last_checkpoint_number(self) -> Optional[int]:
        found_epoch = -1
        if self.folder and os.path.exists(self.folder):
            for name in os.listdir(self.folder):
                if name.startswith("checkpoint_") and name.endswith(".pt"):
                    stem = name[len("checkpoint_"):-3]
                    if stem.isdigit():
                        found_epoch = max(found_epoch, int(stem))
        return found_epoch if found_epoch >= 0 else None

    @staticmethod
    def best_or_last_checkpoint_file(path: str) -> str:
        config = Config(folder=path, load_default=False)
        best = config.checkpoint_file("best")
        if os.path.isfile(best):
            return best
        n = config.last_checkpoint_number()
        if n is not None:
            return config.checkpoint_file(n)
        raise FileNotFoundError(f"no checkpoint found in {path}")


class Configurable:
    """Mixin for components that read options below a configuration key."""

    def __init__(self, config: Config, configuration_key: str = None):
        self._init_configuration(config, configuration_key)

    def _init_configuration(self, config: Config, configuration_key: Optional[str]):
        self.config = config
        self.configuration_key = configuration_key

    def has_option(self, name: str) -> bool:
        try:
            self.get_option(name)
            return True
        except KeyError:
            return False

    def get_option(self, name: str) -> Any:
        if self.configuration_key:
            return self.config.get_default(self.configuration_key + "." + name)
        return self.config.get_default(name)

    def check_option(self, name: str, allowed_values: List[Any]) -> Any:
        if self.configuration_key:
            return self.config.check_default(
                self.configuration_key + "." + name, allowed_values
            )
        return self.config.check_default(name, allowed_values)

    def set_option(self, name: str, value, create: bool = False,
                   overwrite=Config.Overwrite.Yes, log: bool = False) -> Any:
        if self.configuration_key:
            return self.config.set(
                self.configuration_key + "." + name, value, create, overwrite, log
            )
        return self.config.set(name, value, create, overwrite, log)
