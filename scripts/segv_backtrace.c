/* Native backtrace of a fatal signal, for a process preloaded with it.

   gcc -shared -fPIC -O1 -o mcslam_tpu_torch/_build/libsegv_backtrace.so \
       scripts/segv_backtrace.c
   LD_PRELOAD=$PWD/mcslam_tpu_torch/_build/libsegv_backtrace.so \
       python3 chip_smoke.py

   A constructor installs a handler for SIGSEGV, SIGBUS, SIGILL and SIGFPE
   that writes the signal, the faulting address and the native frames
   (glibc backtrace_symbols_fd: library, exported symbol and offset) to
   standard error, then restores the default action and raises the signal
   again. Python's faulthandler, when enabled later, runs first (it prints
   the Python stack) and then hands the signal back to this handler. */

#define _GNU_SOURCE
#include <execinfo.h>
#include <signal.h>
#include <stdio.h>
#include <string.h>
#include <unistd.h>

static void on_fatal(int sig, siginfo_t *info, void *ctx) {
  (void)ctx;
  void *frames[128];
  char msg[160];
  const int n = backtrace(frames, 128);
  const int len = snprintf(msg, sizeof msg,
                           "\n# native backtrace: signal %d, address %p, "
                           "%d frames\n",
                           sig, info ? info->si_addr : NULL, n);
  if (len > 0) (void)!write(STDERR_FILENO, msg, (size_t)len);
  backtrace_symbols_fd(frames, n, STDERR_FILENO);
  signal(sig, SIG_DFL);
  raise(sig);
}

__attribute__((constructor)) static void install(void) {
  static const int sigs[] = {SIGSEGV, SIGBUS, SIGILL, SIGFPE};
  struct sigaction sa;
  memset(&sa, 0, sizeof sa);
  sa.sa_sigaction = on_fatal;
  sa.sa_flags = SA_SIGINFO;
  sigemptyset(&sa.sa_mask);
  void *warm[1];
  backtrace(warm, 1); /* load libgcc_s now, not inside the handler */
  for (size_t i = 0; i < sizeof sigs / sizeof sigs[0]; ++i)
    sigaction(sigs[i], &sa, NULL);
}
