from henjou_torch.utils.timer import Timer, phase_log
