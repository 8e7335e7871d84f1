from henjou.accel.bruteforce import intersect_bruteforce, occluded_bruteforce
