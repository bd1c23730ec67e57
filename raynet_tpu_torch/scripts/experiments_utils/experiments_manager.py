"""Experiment bookkeeping: tagged output dirs, local result archives, txt
metric logs, optional spreadsheet registration.

Port of ``raynet_tpu/scripts/experiments_utils/experiments_manager.py``:
random 20-character experiment tags, <experiment>/weights + /plots
directories, parameters.json + results.npy, and the Metrics txt parser. The
Google-Sheets append needs ``gspread``; without it (or without credentials)
registration appends the same row to a local JSONL file, which the caller
names.
"""
import json
import os
import secrets
import string

import numpy as np


def experiment_tag(n=20):
    alphabet = string.ascii_letters + string.digits
    return "".join(secrets.choice(alphabet) for _ in range(n))


def set_output_directory(output_directory):
    """Create <output>/<tag>/{weights,plots} and return their paths."""
    tag = experiment_tag()
    experiment_directory = os.path.join(output_directory, tag)
    weights_dir = os.path.join(experiment_directory, "weights")
    plots_dir = os.path.join(experiment_directory, "plots")
    for d in (experiment_directory, weights_dir, plots_dir):
        os.makedirs(d, exist_ok=True)
    return experiment_directory, weights_dir, plots_dir


class Metrics:
    """Parse the whitespace metric logs written by MetricsHistory."""

    def __init__(self, train_file, val_file):
        self.train = self._parse(train_file)
        self.val = self._parse(val_file)

    @staticmethod
    def _parse(path):
        if not os.path.isfile(path):
            return {}
        with open(path) as f:
            lines = [l.split() for l in f if l.strip()]
        if not lines:
            return {}
        keys = lines[0]
        cols = list(zip(*lines[1:])) if len(lines) > 1 else [[]] * len(keys)
        return {
            k: np.array([float(v) for v in col])
            for k, col in zip(keys, cols)
        }

    def summary(self):
        out = {}
        for prefix, data in (("train", self.train), ("val", self.val)):
            for k, v in data.items():
                if len(v):
                    out["%s_%s_last" % (prefix, k)] = float(v[-1])
                    out["%s_%s_best" % (prefix, k)] = float(v.min())
        return out


class MetricsHistory:
    """Stream per-batch / per-epoch metric rows to txt files (same format as
    the reference's Keras callback)."""

    def __init__(self, filepath_train, filepath_val, mode="w"):
        self.fd_t = open(filepath_train, mode)
        self.fd_v = open(filepath_val, mode)
        self.keys_t = []
        self.keys_v = []
        # When appending to a resumed run the header row already exists.
        self._skip_header = mode == "a"

    def _on_end(self, fd, keys, logs):
        if not keys:
            keys.extend(sorted(logs.keys()))
            if not self._skip_header:
                print(" ".join(keys), file=fd)
        print(" ".join(str(logs[k]) for k in keys), file=fd)
        fd.flush()

    def on_batch_end(self, logs):
        self._on_end(self.fd_t, self.keys_t, logs)

    def on_epoch_end(self, epoch, logs):
        d = {"epoch": epoch}
        d.update({k: v for k, v in logs.items() if k.startswith("val_")})
        self._on_end(self.fd_v, self.keys_v, d)

    def close(self):
        self.fd_t.close()
        self.fd_v.close()


def save_experiment_locally(experiment_directory, parameters, results):
    """parameters.json + results.npy inside the experiment directory."""
    with open(os.path.join(experiment_directory, "parameters.json"), "w") as f:
        json.dump(
            {k: _jsonable(v) for k, v in parameters.items()}, f, indent=2
        )
    np.save(os.path.join(experiment_directory, "results.npy"), results)


def _jsonable(v):
    if isinstance(v, (np.ndarray, tuple)):
        return list(np.asarray(v).tolist())
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    return v if isinstance(v, (int, float, str, bool, list, type(None))) else str(v)


def load_params_ordering(path=None):
    """Column ordering for the registration row: one parameter name per
    line. Defaults to the repository's
    config/pretrain_network_experiment_params.txt; returns None when no
    ordering file exists (all params, sorted)."""
    if path is None:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))
            ))),
            "config", "pretrain_network_experiment_params.txt",
        )
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return [l.strip() for l in f if l.strip()]


def build_registration_row(parameters, results, tag=None,
                           params_ordering=None):
    """One flat spreadsheet row: [tag] + ordered parameter values +
    flattened results. Parameters missing from the ordering render as ''
    so the sheet columns stay aligned."""
    if params_ordering is None:
        params_ordering = load_params_ordering() or sorted(parameters)
    row = [tag if tag is not None else experiment_tag()]
    for k in params_ordering:
        v = parameters.get(k, "")
        row.append(json.dumps(_jsonable(v)) if isinstance(
            v, (list, tuple, np.ndarray, dict)
        ) else _jsonable(v))
    row.extend(
        float(x) for x in np.asarray(results, dtype=np.float64).reshape(-1)
    )
    return row


class GspreadSheetsClient:
    """Thin Google-Sheets append client over gspread service-account
    auth. Instantiation requires gspread and a credentials keyfile; tests
    inject a fake with the same append_row surface."""

    def __init__(self, credentials_path):
        import gspread  # optional dependency; ImportError -> fallback

        self._gc = gspread.service_account(filename=credentials_path)

    def append_row(self, spreadsheet_id, sheet, row):
        ws = self._gc.open_by_key(spreadsheet_id).worksheet(sheet)
        ws.append_row(
            [str(v) for v in row], value_input_option="USER_ENTERED"
        )


def register_experiment(credentials, spreadsheet, parameters, results,
                        fallback, sheet="Sheet1", tag=None,
                        params_ordering=None, client=None):
    """Append one experiment row to a Google Sheet; without the gspread
    stack (or credentials) append the same row to the local JSONL file
    ``fallback``, so offline runs keep a registry.

    ``client``: any object with append_row(spreadsheet, sheet, row) —
    the injection point that keeps the sheet path offline-testable.
    Returns "sheet" when the row went to the spreadsheet, else the
    fallback file path."""
    row = build_registration_row(
        parameters, results, tag=tag, params_ordering=params_ordering
    )
    if client is None and credentials and os.path.isfile(str(credentials)):
        try:
            client = GspreadSheetsClient(credentials)
        except ImportError:
            client = None
    if client is not None:
        client.append_row(spreadsheet, sheet, row)
        return "sheet"
    with open(fallback, "a") as f:
        f.write(
            json.dumps(
                {
                    "spreadsheet": spreadsheet,
                    "sheet": sheet,
                    "row": [_jsonable(v) for v in row],
                    "parameters": {
                        k: _jsonable(v) for k, v in parameters.items()
                    },
                    "results": _jsonable(results),
                }
            )
            + "\n"
        )
    return fallback
