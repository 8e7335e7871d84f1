from henjou.utils.timer import Timer, phase_log
