"""Per-op communication statistics.

Port of ``deepspeed_tpu/utils/comms_logging.py`` (``CommsLogger``: per-op,
per-message-size counts, latencies, algorithm and bus bandwidth, and the
straggler summary of ``comm.log_summary``). The port adds one tally the
reference has no use for: ``host_staged``, the collectives whose CUDA
tensors went through the host because the gloo backend has no CUDA
implementation of them, with the bytes copied each way.
"""

import math
from collections import defaultdict

from deepspeed_tpu_torch.utils.logging import logger


def get_caller_func(frame=3):
    import sys
    return sys._getframe(frame).f_code.co_name


def convert_size(size_bytes):
    if size_bytes == 0:
        return "0B"
    size_name = ("B", "KB", "MB", "GB", "TB", "PB")
    i = int(math.floor(math.log(size_bytes, 1024)))
    p = math.pow(1024, i)
    s = round(size_bytes / p, 2)
    return f"{s} {size_name[i]}"


def calc_bw_log(comm_op, size, duration, n):
    """Algorithm and bus bandwidth of a collective (GB/s) and its ms."""
    if duration <= 0:
        return 0, 0, 0
    tput = size / duration
    if comm_op in ("all_to_all_single", ):
        busbw = tput * ((n - 1) / n) if n > 0 else tput
    elif comm_op in ("all_gather_into_tensor", "reduce_scatter_tensor", "allgather_fn", "reduce_scatter_fn"):
        busbw = tput * ((n - 1) / n) if n > 0 else tput
    elif comm_op in ("all_reduce", "inference_all_reduce"):
        busbw = tput * (2 * (n - 1) / n) if n > 0 else tput
    else:
        busbw = tput
    return tput / 1e9, busbw / 1e9, duration * 1e3


class CommsLogger:

    def __init__(self):
        self.comms_dict = defaultdict(lambda: defaultdict(lambda: [0, [], [], []]))
        self.verbose = False
        self.debug = False
        self.prof_ops = []
        self.prof_all = True
        self.enabled = False
        # op -> [collectives staged through the host, bytes copied to it, bytes copied back]
        self.host_staged = defaultdict(lambda: [0, 0, 0])

    def configure(self, deepspeed_config=None, enabled=None, prof_all=None, prof_ops=None, verbose=None, debug=None):
        if deepspeed_config is not None:
            cl = getattr(deepspeed_config, "comms_config", None)
            if cl is not None:
                self.enabled = cl.enabled
                self.prof_all = cl.prof_all
                self.prof_ops = cl.prof_ops
                self.verbose = cl.verbose
                self.debug = cl.debug
        if enabled is not None:
            self.enabled = enabled
        if prof_all is not None:
            self.prof_all = prof_all
        if prof_ops is not None:
            self.prof_ops = prof_ops
        if verbose is not None:
            self.verbose = verbose
        if debug is not None:
            self.debug = debug

    def append(self, raw_name, record_name, latency, msg_size, n=1):
        if self.prof_ops and raw_name not in self.prof_ops and not self.prof_all:
            return
        entry = self.comms_dict[record_name][msg_size]
        algbw, busbw, lat_ms = calc_bw_log(raw_name, msg_size, latency, n)
        entry[0] += 1
        entry[1].append(lat_ms)
        entry[2].append(algbw)
        entry[3].append(busbw)
        if self.verbose:
            logger.info(f"comm op: {record_name} | time (ms): {lat_ms:.2f} | "
                        f"msg size: {convert_size(msg_size)} | algbw (Gbps): {algbw*8:.2f} | "
                        f"busbw (Gbps): {busbw*8:.2f}")

    def record_host_staging(self, op, bytes_to_host, bytes_from_host):
        """One collective whose CUDA tensors were copied to the host and back."""
        entry = self.host_staged[op]
        entry[0] += 1
        entry[1] += int(bytes_to_host)
        entry[2] += int(bytes_from_host)

    def log_all(self, print_log=True, show_straggler=False):
        from numpy import mean
        lines = [f"{'Comm. Op':<20}{'Message Size':<20}{'Count':<10}"
                 f"{'Total Latency(ms)':<20}{'Avg Latency(ms)':<20}{'tput_avg (Gbps)':<20}{'busbw_avg (Gbps)':<20}"]
        for record_name in self.comms_dict.keys():
            lines.append(record_name)
            for msg_size, vals in sorted(self.comms_dict[record_name].items()):
                count, latencies, algbws, busbws = vals
                lines.append(f"{'':<20}{convert_size(msg_size):<20}{count:<10}"
                             f"{sum(latencies):<20.2f}{mean(latencies):<20.2f}"
                             f"{mean(algbws)*8:<20.2f}{mean(busbws)*8:<20.2f}")
        if self.host_staged:
            lines.append("")
            lines.append(f"{'Staged via host':<20}{'Count':<10}{'To host':<20}{'From host':<20}")
            for op, (count, to_host, from_host) in sorted(self.host_staged.items()):
                lines.append(f"{op:<20}{count:<10}{convert_size(to_host):<20}{convert_size(from_host):<20}")
        if show_straggler:
            lines.append("")
            lines.extend(self._straggler_summary())
        out = "\n".join(lines)
        if print_log:
            logger.info("\n" + out)
        return out

    def _straggler_summary(self):
        """Per-op straggler effect: over several processes the slowest rank's
        mean latency against the gang's mean (a collective: every rank must
        call it); in one process the largest against the mean."""
        from numpy import mean
        lines = [f"{'Straggler summary':<20}",
                 f"{'Comm. Op':<20}{'Count':<10}{'Mean Lat(ms)':<16}"
                 f"{'Max Lat(ms)':<16}{'Straggler(ms)':<16}"]
        cross = self._cross_process_stats()
        for record_name, sizes in self.comms_dict.items():
            lats = [lat for vals in sizes.values() for lat in vals[1]]
            if not lats:
                continue
            local_mean, local_max = float(mean(lats)), float(max(lats))
            if cross is not None and record_name in cross:
                g_mean, g_max = cross[record_name]
                straggler = g_max - g_mean
                local_mean, local_max = g_mean, g_max
            else:
                straggler = local_max - local_mean
            lines.append(f"{record_name:<20}{len(lats):<10}{local_mean:<16.2f}"
                         f"{local_max:<16.2f}{straggler:<16.2f}")
        return lines

    def _cross_process_stats(self):
        """{op: (mean of the ranks' means, slowest rank's mean)} in ms over a
        gang of several processes, else None."""
        try:
            import numpy as np
            import torch
            import torch.distributed as tdist
            if not (tdist.is_available() and tdist.is_initialized()) or tdist.get_world_size() <= 1:
                return None
            ops = sorted(self.comms_dict.keys())
            if not ops:
                return None
            means = torch.tensor([np.mean([lat for vals in self.comms_dict[op].values() for lat in vals[1]] or [0.0])
                                  for op in ops], dtype=torch.float64)
            gathered = [torch.zeros_like(means) for _ in range(tdist.get_world_size())]
            tdist.all_gather(gathered, means)
            g = torch.stack(gathered).numpy()
            return {op: (float(g[:, i].mean()), float(g[:, i].max())) for i, op in enumerate(ops)}
        except Exception:
            return None
